"""The readers of the port's own spans (jxlbench/program_spans.py and the
metrics that use it) on a synthetic trace whose values are worked out by
hand, on a trace without the port's spans, and in a traced run."""

import types

import pytest

from jxlbench import harness
from jxlbench.trace import DeviceTrace

from .conftest import BENCH, manifest, run_cpu, tiny

WINDOW = harness.WINDOW
# (name, start us, end us) of the host ranges, in a window of 0-1000 us:
# a decode (0-400) with its stages, a batch decode (450-900) with its plan
# and a stage nested in a stage, a DC span that the window's end cuts, and
# one of the harness's own spans, which the readers leave alone
HOST = [("jxl.decode", 0, 400), ("jxl.headers", 10, 20),
        ("decode_vardct_frame", 20, 250), ("jxl.frame.dc", 20, 100),
        ("jxl.frame.ac_global", 100, 150), ("jxl.frame.ac", 150, 250),
        ("jxl.stage", 250, 300), ("jxl.program.load", 300, 320),
        ("jxl.program.replay", 320, 330),
        ("jxl.program.readback", 330, 380),
        ("jxl.decode_batch_entropy", 450, 900),
        ("jxl.entropy.plan", 460, 600), ("jxl.stage", 600, 650),
        ("jxl.stage", 620, 640), ("jxl.frame.dc", 950, 1100)]
# device busy 300-320 and 325-380, so idle 0-300, 320-325 and 380-1000
OPS = [("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 300, 320),
       ("render_tail_kernel", "kernel", 325, 360),
       ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 360, 380)]
# two calls that returned and one that raised
CALLS = [{"raised": False}, {"raised": False}, {"raised": True}]
# idle with no span open or only a root: 0-10 (the decode's root), 380-400
# (the root), 400-450 (none), 450-460 and 650-900 (the batch's root),
# 900-950 (none): 390 us of 925
IDLE_UNATTRIBUTED = 100.0 * 390 / 925
# host us of each span name over the two calls that returned, in ms
MS = {"frame_dc_ms": (80 + 50) / 2e3, "frame_ac_global_ms": 50 / 2e3,
      "ac_entropy_ms": 100 / 2e3, "lane_plan_ms": 140 / 2e3,
      "stage_ms": (50 + 50) / 2e3, "slot_load_ms": 20 / 2e3,
      "readback_ms": 50 / 2e3}
NEW = sorted(p["name"] for p in manifest()["per_layer"]
             if p["name"].split(".")[0] in (*MS, "idle_unattributed"))


def _events(host):
    ev = [{"name": WINDOW, "ph": "X", "cat": "user_annotation", "ts": 0,
           "dur": 1000}]
    ev += [{"name": n, "ph": "X", "cat": "user_annotation", "ts": a,
            "dur": b - a} for n, a, b in host]
    ev += [{"name": n, "ph": "X", "cat": c, "ts": a, "dur": b - a,
            "args": {"device": 0}} for n, c, a, b in OPS]
    return ev


def _ctx(host):
    return types.SimpleNamespace(trace=DeviceTrace(_events(host), WINDOW),
                                 calls=CALLS, chips=1)


def _read(name, ctx):
    return harness.load_module(BENCH / "metrics" / f"{name}.py",
                               f"jxlbench_metric_{name}").read(ctx)


def test_the_new_metrics_are_the_fourteen():
    assert len(NEW) == 14


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_the_hand_computed_value(name):
    base = name.split(".")[0]
    want = IDLE_UNATTRIBUTED if base == "idle_unattributed" else MS[base]
    assert _read(name, _ctx(HOST)) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_nothing_without_the_ports_spans(name):
    """A program older than its spans: the harness's spans alone."""
    host = [("decode_vardct_frame", 20, 250), ("_parse", 10, 300)]
    assert _read(name, _ctx(host)) is None


def test_idle_under_a_leaf_a_root_and_no_span():
    """Idle time under a stage's span is attributed, under a root alone or
    outside every span it is not."""
    leaf = [("jxl.decode", 0, 1000), ("jxl.frame.ac", 0, 300)]
    assert _read("idle_unattributed.single", _ctx(leaf)) == \
        pytest.approx(100.0 * 625 / 925)
    root = [("jxl.decode", 0, 1000), ("jxl.headers", 0, 0.5)]
    assert _read("idle_unattributed.single", _ctx(root)) == \
        pytest.approx(100.0 * 924.5 / 925)
    outside = [("jxl.headers", 900, 1000)]
    assert _read("idle_unattributed.single", _ctx(outside)) == \
        pytest.approx(100.0 * 825 / 925)


def test_traced_run_reads_the_ports_spans(tmp_path):
    """A traced CPU run of the single-frame cell reports its new metrics
    but the slot loads (the CPU runs a program's body directly)."""
    root, bench = tiny(tmp_path, size=256, streams=1)
    out, lines = run_cpu(root, bench, "photo2k_d1_e5.single", trace=True,
                         seconds=0.5)
    assert out["correct"], lines
    got = {k for k in out["metrics"] if k in NEW}
    assert got == {n for n in NEW if n.endswith(".single")} \
        - {"slot_load_ms.single"}
    assert 0.0 <= out["metrics"]["idle_unattributed.single"]["value"] \
        <= 100.0
