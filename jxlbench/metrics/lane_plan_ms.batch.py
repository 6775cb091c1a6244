"""Host ms a batch in the device-entropy lane plan (jxl.entropy.plan:
ans_tpu.build_plan, ans_kernel.build_lane_plan and program_plan)."""

from jxlbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, "jxl.entropy.plan")
