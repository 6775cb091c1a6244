"""The port's spans (libjxl_tpu_torch/base/device.span) on the CPU.

With no profiler recording, a span is one shared null context and never
enters torch.profiler.record_function. Under torch.profiler, the single
decode and the device-entropy batch decode mark their host stages and
their program calls inside their request's root span, and a program's
capture and replay calls mark their steps in order (the CUDA graph
stubbed as tests/test_torch_programs.py stubs it).
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libjxl_tpu_torch.api import codestream, tpu_codec
from libjxl_tpu_torch.base import device
from libjxl_tpu_torch.ops import programs
from tests.test_ans_kernel import _image
from tests.test_torch_programs import (CUDA0, _counting_body,  # noqa: F401
                                       stub_capture)

FRAME_SPANS = ("jxl.headers", "jxl.frame.init", "jxl.frame.dc",
               "jxl.frame.ac_global", "jxl.frame.ac", "jxl.stage",
               "jxl.program.eager")


def _spans(fn, tmp_path):
    """fn() under torch.profiler on the CPU: (its result, the port's spans
    in the exported trace as (name, start us, end us), by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = sorted((e["ts"], -e["dur"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and e["name"].startswith("jxl."))
    return out, [(n, ts, ts - d) for ts, d, n in got]


def _inside(spans, root, names):
    """Each of `names` is among `spans` and each of its spans lies inside
    the one span `root`."""
    (r0, r1), = [(a, b) for n, a, b in spans if n == root]
    for name in names:
        mine = [(a, b) for n, a, b in spans if n == name]
        assert mine, f"no {name} span"
        assert all(r0 <= a <= b <= r1 for a, b in mine), name


@pytest.fixture(scope="module")
def streams():
    """A 384^2 e5 frame (four AC groups, the native bulk entropy decode)
    and two 512^2 e3 frames in the device-entropy path's scope."""
    e5 = codestream.encode_lossy(_image(384, 3), distance=1.0, effort=5,
                                 device=None)
    e3 = [codestream.encode_lossy(_image(512, s), distance=4.0, effort=3,
                                  device=None) for s in (7, 8)]
    return e5, e3


def test_no_profiler_no_record_function(monkeypatch, streams):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a "
                             "profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert device.span("jxl.decode") is device.span("jxl.stage")
    with device.span("jxl.decode"):
        pass
    img, _ = codestream.decode(streams[0], device="cpu", num_threads=2)
    assert img.shape == (384, 384, 3)


def test_single_decode_spans_inside_its_root(streams, tmp_path):
    (img, _), spans = _spans(lambda: codestream.decode(
        streams[0], device="cpu", num_threads=2), tmp_path)
    assert img.shape == (384, 384, 3)
    _inside(spans, "jxl.decode", FRAME_SPANS)
    assert [n for n, _, _ in spans].count("jxl.frame.ac") == 1


def _blank_entropy_program(lanes, inv_order, render_args, geometry, las,
                           t_alloc, config):
    """The "entropy" program's outputs, blank: the rANS twin's step loop is
    over a million torch ops, which the profiler would record one by
    one."""
    batch = len(render_args[0])
    return (torch.zeros((batch, config.height, config.width, 3),
                        dtype=torch.uint8), torch.ones(1, dtype=torch.int32))


def test_batch_entropy_spans_inside_its_root(streams, tmp_path,
                                             monkeypatch):
    monkeypatch.setattr(tpu_codec, "_entropy_program",
                        _blank_entropy_program)
    (images, info), spans = _spans(lambda: tpu_codec.decode_batch_entropy(
        streams[1], device="cpu"), tmp_path)
    assert info["path"] == "device_entropy" and len(images) == 2
    _inside(spans, "jxl.decode_batch_entropy",
            FRAME_SPANS + ("jxl.entropy.plan",))
    # a section span a frame, not one a group
    assert [n for n, _, _ in spans].count("jxl.frame.dc") == 2


def _top_level_program_spans(spans):
    """The program layer's spans that no other of them holds, by start."""
    prog = [s for s in spans if s[0].startswith("jxl.program.")]
    return [n for n, a, b in prog
            if not any(o != (n, a, b) and o[1] <= a and b <= o[2]
                       for o in prog)]


def test_program_calls_mark_their_steps(stub_capture, tmp_path):
    def call():
        return programs.run("count", (), _counting_body,
                            np.ones(3, np.float32), 2.0, device=CUDA0,
                            readback=True)

    _, eager = _spans(call, tmp_path)
    assert _top_level_program_spans(eager) == ["jxl.program.eager"]
    _, second = _spans(call, tmp_path)
    assert _top_level_program_spans(second) == [
        "jxl.program.capture", "jxl.program.replay", "jxl.program.readback"]
    out, third = _spans(call, tmp_path)
    assert _top_level_program_spans(third) == [
        "jxl.program.load", "jxl.program.replay", "jxl.program.readback"]
    assert out.tolist() == [2.0] * 3
