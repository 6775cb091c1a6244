"""The JPEG transcode configuration and its cell
(jpeg12mp_q90_420.transcode_single): its files found by name and run on
the CPU at a small size, a planted fault in the chroma upsampling caught,
its maker free of the program, its frozen recompressor equal to the
port's but for libjxl's block contexts, and its per-layer metrics read
from the port's spans."""

import json

import numpy as np
import pytest

from .conftest import BENCH, ROOT, run_cpu, tiny
from .test_bench_imports import JAX, loaded_after

CELL = "jpeg12mp_q90_420.transcode_single"
# the cell's per-layer metrics: the single-frame cell's readers, which
# list it beside that cell, and host_ms.transcode, which stops at the
# render's program call
NEW = ["host_ms.transcode"] + [f"{m}.single" for m in (
    "decode_p95_ms", "replay_share", "copy_ms", "device_idle",
    "peak_mem_gb", "frame_dc_ms", "frame_ac_global_ms", "ac_entropy_ms",
    "stage_ms", "slot_load_ms", "readback_ms", "idle_unattributed")]


@pytest.fixture(scope="module")
def transcode_root(tmp_path_factory):
    # 320 px: two AC groups a side, so the frame takes the native AC route
    return tiny(tmp_path_factory.mktemp("t"), size=320, streams=2)


def test_cell_is_in_the_manifest():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in m["workloads"]}[CELL]
    assert cell["chips"] == 1 and cell["traffic"] == "transcode_single"
    cfg = json.loads((BENCH / "configs" / "jpeg12mp_q90_420.json")
                     .read_text())
    assert (cfg["width"], cfg["height"], cfg["streams"]) == (4032, 3024, 4)
    assert cfg["limits"]["max_steps"] == 1
    assert cfg["limits"]["off_share"] == 0.001
    single = {e["name"]: e for e in m["end_to_end"]}["single_ms"]
    assert CELL in single["workloads"]
    traffic = json.loads((BENCH / "traffic" / "transcode_single.json")
                         .read_text())
    assert traffic["require"] == {"path_prefix": "device:u8-ycbcr",
                                  "launches": ["ac_native_sub"]}
    assert (traffic["per_call"], traffic["warmup_calls"],
            traffic["args"]["num_threads"]) == (1, 4, 4)
    got = {p["name"] for p in m["per_layer"] if CELL in p["workloads"]}
    assert got == set(NEW)


def test_cell_runs_on_the_cpu(transcode_root):
    """The cell's files run without an edit to the harness: every call
    served through the device YCbCr render and the native AC decode."""
    from libjxl_tpu_torch.base.device import launch_counts

    before = launch_counts().get("ac_native_sub", 0)
    out, lines = run_cpu(*transcode_root, CELL, seconds=0.5)
    assert out["correct"] and out["failed"] == 0, lines
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"single_ms", "setup_s"}
    assert launch_counts().get("ac_native_sub", 0) - before \
        == out["attempted"] + 1  # and the warm-up call


def test_traced_run_reports_the_new_metrics(transcode_root):
    """The traced run reports the cell's per-layer metrics but the slot
    loads, copies and graph replays (the CPU runs a program's body
    directly) and the card's idle share and memory peak (no card)."""
    out, lines = run_cpu(*transcode_root, CELL, trace=True, seconds=0.5)
    assert out["correct"], lines
    assert set(out["metrics"]) == set(NEW) - {
        "slot_load_ms.single", "copy_ms.single", "replay_share.single",
        "device_idle.single", "peak_mem_gb.single"}
    m = out["metrics"]
    assert 0 < m["ac_entropy_ms.single"]["value"] \
        < m["host_ms.transcode"]["value"]
    assert m["stage_ms.single"]["value"] > 0


def test_box_upsampled_frame_is_not_correct(transcode_root, monkeypatch):
    """Chroma repeated (the upsampling the port had) in the device
    program's place: the cell comes out as not correct."""
    from libjxl_tpu_torch.ops import pipeline

    def box(plane, dim, n, extent, shift):
        if not shift:
            return plane.narrow(dim, 0, n)
        return plane.repeat_interleave(1 << shift, dim).narrow(dim, 0, n)

    monkeypatch.setattr(pipeline, "_upsample_axis", box)
    out, lines = run_cpu(*transcode_root, CELL, seconds=0.3)
    assert out["failed"] == 0, lines
    assert out["correct"] is False, lines
    assert out["compared"]["off_share"]["value"] > 0.01


def test_maker_imports_nothing_of_the_program():
    names = loaded_after(
        "from jxlbench.makers import jpeg_transcode as m\n"
        "cfg = {'height': 96, 'width': 136, 'quality': 90}\n"
        "s, ref, facts = m.make(cfg, 2 ** 33 + 5, 1)\n"
        "assert ref.shape == (96, 136, 3) and facts['bytes'] == len(s)\n"
        "m.control(s)\n")
    assert not names & (JAX | {"libjxl_tpu_torch"}), names


def _decoded_coefficients(stream):
    """The port's host decode of a transcode up to its coefficients:
    the dense AC planes and the DC, per channel."""
    from libjxl_tpu_torch.api.codestream import parse_codestream_header
    from libjxl_tpu_torch.io.bits import BitReader
    from libjxl_tpu_torch.io.container import extract_codestream
    from libjxl_tpu_torch.io.frame_header import FrameHeader
    from libjxl_tpu_torch.vardct.frame import decode_vardct_frame
    from libjxl_tpu_torch.vardct.subsampled import dense_planes

    r = BitReader(extract_codestream(stream))
    fh = FrameHeader(parse_codestream_header(r))
    fh.read(r)
    cap = {}

    def capture(state):
        cap["state"] = state
        state.restoration_done = state.device_output_done = True

    decode_vardct_frame(r, fh, render_fn=capture)
    st = cap["state"]
    return dense_planes(st), st.dc_sub, st.block_ctx_map


@pytest.mark.parametrize("h,w", [(64, 80), (201, 265), (520, 600),
                                 (768, 1024)])
def test_frozen_transcode_equals_the_ports(h, w):
    """The frozen JPEG coefficients and recompression against the port's
    jpegli (quality 90, 4:2:0, standard tables, no adaptive
    quantization) and recompress_jpeg_vardct: the same coefficients; the
    two codestreams differ in the block context map alone (libjxl's for
    JPEG input against the port's default), so the port decodes both to
    the same coefficients; read_coefficients gives them back."""
    from jxlbench.makers import vardct_photo
    from jxlbench.refcodec import jpeg_transcode as jt
    from libjxl_tpu_torch.io.container import extract_codestream
    from libjxl_tpu_torch.jpeg.data import parse_jpeg
    from libjxl_tpu_torch.jpeg.recompress import recompress_jpeg_vardct
    from libjxl_tpu_torch.jpegli import encode_jpegli

    img = vardct_photo.make_image(h, w, np.random.default_rng(h))
    comps = jt.jpeg_components(img, 90)
    jpg = encode_jpegli(img, quality=90, subsampling="420",
                        std_tables=True, adaptive=False, optimize=False)
    jd = parse_jpeg(jpg)
    for (zz, table, hs, vs), c in zip(comps, jd.components):
        np.testing.assert_array_equal(zz, c.coeffs)
        np.testing.assert_array_equal(table, jd.quant[c.quant_idx])
        assert (hs, vs) == (c.h_samp, c.v_samp)
    stream = jt.transcode(comps, w, h)
    ports = recompress_jpeg_vardct(jpg)
    assert extract_codestream(stream) != extract_codestream(ports)
    planes, dc, bcm = _decoded_coefficients(stream)
    want_planes, want_dc, default = _decoded_coefficients(ports)
    assert default.num_dc_ctxs == 1 and bcm.ctx_map != default.ctx_map
    assert bcm.num_dc_ctxs == (2 if h * w >= 768 * 1024 else 1)
    for c in range(3):
        np.testing.assert_array_equal(planes[c], want_planes[c])
        np.testing.assert_array_equal(dc[c], want_dc[c])
    back, bw, bh = jt.read_coefficients(stream)
    assert (bw, bh) == (w, h)
    for a, b in zip(back, comps):
        np.testing.assert_array_equal(a[0][:b[0].shape[0], :b[0].shape[1]],
                                      b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]


def test_block_contexts_are_libjxls():
    """block_ctx_map of a JPEG's DC against the map libjxl 0.7 wrote in
    its transcode of that JPEG (tests/data/transcode, 1024x768 4:2:0):
    the same thresholds, contexts and map."""
    from jxlbench.refcodec import jpeg_transcode as jt
    from libjxl_tpu_torch.jpeg.data import parse_jpeg

    data = ROOT / "tests" / "data" / "transcode" / "dc_contexts_420"
    jd = parse_jpeg(data.with_suffix(".jpg").read_bytes())
    dc = [None] * 3
    for ji, comp in enumerate(jd.components):
        dc[jt.JXL_CHANNEL[ji]] = comp.coeffs[..., 0].astype(np.int64)
    got = jt.block_ctx_map(dc)
    want = _decoded_coefficients(data.with_suffix(".jxl").read_bytes())[2]
    assert got.dc_thresholds == want.dc_thresholds == [[], [-27], []]
    assert (got.num_dc_ctxs, got.num_ctxs) == (want.num_dc_ctxs,
                                               want.num_ctxs)
    assert list(got.ctx_map) == list(want.ctx_map)


def test_reference_is_the_tests_reference():
    """jxlbench/refs/jpeg_transcode_ref.py is the copy of the tests' plain
    reference (tests/reference/jpeg_transcode_ref.py)."""
    assert (BENCH / "refs" / "jpeg_transcode_ref.py").read_bytes() == \
        (ROOT / "tests" / "reference" / "jpeg_transcode_ref.py").read_bytes()


def test_port_decode_is_within_the_limits_of_the_reference():
    """The maker's stream decoded by the port on the CPU (the device
    program's plain twins) against the maker's reference: inside the
    configuration's limits; the control outside them."""
    from jxlbench import compare
    from jxlbench.makers import jpeg_transcode as maker
    from libjxl_tpu_torch.api import codestream

    cfg = {"height": 264, "width": 328, "quality": 90}
    limits = json.loads((BENCH / "configs" / "jpeg12mp_q90_420.json")
                        .read_text())["limits"]
    stream, ref, _ = maker.make(cfg, 7, 0)
    got, _ = codestream.decode(stream, device="cpu")
    tally = compare.Tally()
    tally.add(got, ref)
    assert tally.verdict(limits)[0], (tally.max_steps, tally.off_share)
    tally = compare.Tally()
    tally.add(maker.control(stream), ref)
    assert not tally.verdict(limits)[0]
