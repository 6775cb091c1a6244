"""Host ms a batch in the port's host stage: tpu_codec.prepare_batch or
prepare_batch_entropy (parse, entropy decode or lane plan, staging)."""

from jxlbench import readers


def read(ctx):
    return readers.span_mean_ms(
        ctx, ("prepare_batch", "prepare_batch_entropy"))
