"""Whole decodes through libjxl_tpu_torch's single-image device render
(api/tpu_codec.py's make_device_render and decode, the device argument
of api/codestream's decode and decode_frames) against the JAX package's
device=True decodes on the CPU; the stages are held one by one in
tests/test_torch_device_render.py.

The JAX side runs its XLA forms (JAX_PLATFORMS=cpu). u8 output is held to
at most 1 step, with (diff != 0).mean() < 1e-3 as tests/test_tpu_codec.py
holds the JAX device render to the host; path records exactly.
"""

import json
import logging
import pathlib

import numpy as np
import pytest
import torch

from libjxl_tpu.api import codestream as jcs
from libjxl_tpu.api import tpu_codec as jtc
from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.api import tpu_codec as ttc

CONFORMANCE = pathlib.Path(__file__).resolve().parent / "data" / \
    "conformance"


def _photo(h, w, seed):
    """Smooth content, a textured patch and mild noise: the e5/e7
    encoders choose size passes and 8x8 special tiles on it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (120 + 60 * np.sin(xx * 0.03) + 50 * np.cos(yy * 0.02 + 1)
           + 20 * np.sin((xx + yy) * 0.1) + rng.normal(0, 5, (h, w)))
    patch = (slice(h // 3, h // 2), slice(w // 4, w // 2))
    img[patch] += 60 * ((xx[patch] // 4) % 2)
    rgb = np.stack([img, img * 0.9 + 10, img * 1.1 - 12], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _subsampled_stream(h, w, mode, filters):
    """tests/test_decode_path.py's 4:2:0 YCbCr stream builder, with 4:2:2
    and Gaborish + 2 EPF passes as options (the port's encoder)."""
    from libjxl_tpu_torch.io.bits import BitWriter
    from libjxl_tpu_torch.io.frame_header import (
        CT_YCBCR, ENC_VARDCT, FLAG_SKIP_ADAPTIVE_DC_SMOOTHING, FT_REGULAR,
        FrameHeader)
    from libjxl_tpu_torch.io.headers import CodecMetadata, SizeHeader
    from libjxl_tpu_torch.vardct.frame import rgb_to_ycbcr
    from libjxl_tpu_torch.vardct.subsampled import encode_vardct_subsampled

    img = _photo(h, w, 5)
    meta = CodecMetadata()
    meta.size = SizeHeader().set(w, h)
    meta.m.all_default = False
    meta.m.xyb_encoded = False
    wr = BitWriter()
    tcs.write_codestream_header(wr, meta)
    fh = FrameHeader(meta)
    fh.all_default = False
    fh.frame_type = FT_REGULAR
    fh.encoding = ENC_VARDCT
    fh.color_transform = CT_YCBCR
    fh.chroma_subsampling.channel_mode = [0, 1, 0] if mode == "420" \
        else [0, 2, 0]
    fh.flags = FLAG_SKIP_ADAPTIVE_DC_SMOOTHING
    fh.loop_filter.all_default = False
    fh.loop_filter.gab = filters
    fh.loop_filter.epf_iters = 2 if filters else 0
    hs = [fh.chroma_subsampling.hshift(c) for c in range(3)]
    vs = [fh.chroma_subsampling.vshift(c) for c in range(3)]
    ycbcr = rgb_to_ycbcr(np.moveaxis(img.astype(np.float64) / 255, -1, 0))

    def ds(p, fy, fx):
        h2, w2 = p.shape[0] // fy * fy, p.shape[1] // fx * fx
        return p[:h2, :w2].reshape(h2 // fy, fy, w2 // fx, fx).mean(
            axis=(1, 3))

    planes = [ds(ycbcr[c], 1 << vs[c], 1 << hs[c]) for c in range(3)]
    encode_vardct_subsampled(wr, planes, fh, distance=1.0)
    return wr.get_bytes()


_STREAMS = {
    "e5": lambda: jcs.encode_lossy(_photo(256, 256, 3), distance=1.0,
                                   effort=5, device=False),
    "e7": lambda: jcs.encode_lossy(_photo(256, 256, 4), distance=1.0,
                                   effort=7, device=False),
    "odd-true-size": lambda: jcs.encode_lossy(_photo(250, 189, 5),
                                              distance=1.0, effort=5,
                                              device=False),
    "epf3": lambda: jcs.encode_lossy(_photo(128, 128, 6), distance=1.0,
                                     effort=5, epf=3, device=False),
    "noise": lambda: jcs.encode_lossy(_photo(128, 128, 7), distance=1.0,
                                      effort=5, photon_noise_iso=1600.0,
                                      device=False),
    "ycbcr420": lambda: _subsampled_stream(120, 144, "420", False),
    "ycbcr422-filters": lambda: _subsampled_stream(90, 100, "422", True),
    "jpeg_recon": lambda: (CONFORMANCE / "jpeg_recon.jxl").read_bytes(),
}
PATHS = {"e5": "device:u8", "e7": "device:u8",
         "odd-true-size": "device:xyb", "epf3": "device:u8",
         "noise": "device:xyb", "ycbcr420": "device:u8-ycbcr",
         "ycbcr422-filters": "device:u8-ycbcr",
         "jpeg_recon": "device:u8-ycbcr"}


def _u8_close(got, ref, what):
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1, (what, int(diff.max()))
    if got.dtype == np.uint8:
        assert (diff != 0).mean() < 1e-3, (what, float((diff != 0).mean()))


def _subsampled_reference(name, data):
    """What a chroma-subsampled stream decodes to: the JPEG transcode of
    the corpus, the plain decode of its JPEG's coefficients
    (tests/reference/jpeg_transcode_ref.py); the others, libjxl's decode
    (the port's host route where libjxl is not installed). The JAX
    package repeats chroma samples where libjxl interpolates them (up to
    96 u8 steps apart at a saturated edge), so it is no reference here."""
    from libjxl_tpu_torch.extras import oracle
    from libjxl_tpu_torch.jpeg.data import parse_jpeg
    from reference import jpeg_transcode_ref

    if name == "jpeg_recon":
        jpg = (CONFORMANCE / "jpeg_recon.jpg").read_bytes()
        return jpeg_transcode_ref.decode_parsed(parse_jpeg(jpg))
    if oracle.available():
        return oracle.decode(data)[0][:, :, :3]
    return tcs.decode(data, device=None)[0]


@pytest.mark.parametrize("name", list(_STREAMS))
def test_decode_on_device_matches_jax_device_decode(name):
    """decode(..., device="cpu") against the JAX decode(..., device=True):
    the same path record, u8 within 1 step, and within 1 step of the
    port's host decode. A chroma-subsampled frame is held to
    _subsampled_reference in the JAX decode's place (with Gaborish and
    EPF too: the device render mirrors past the true size before its
    filters, as the host's does)."""
    data = _STREAMS[name]()
    jinfo, tinfo = {}, {}
    ref, _ = jcs.decode(data, device=True, decode_info=jinfo)
    got, _ = tcs.decode(data, device="cpu", decode_info=tinfo)
    assert tinfo["path"] == jinfo["path"] == PATHS[name], (tinfo, jinfo)
    if PATHS[name] == "device:u8-ycbcr":
        ref = _subsampled_reference(name, data)
    _u8_close(got, ref, name)
    _u8_close(got, tcs.decode(data, device=None)[0], f"{name} vs host")


def _pixel_cases():
    cases = json.loads((CONFORMANCE / "manifest.json").read_text())["cases"]
    return [c for c in cases if c["kind"] == "lossy"]


@pytest.mark.parametrize("case", _pixel_cases(),
                         ids=[c["name"] for c in _pixel_cases()])
def test_decode_on_device_conformance(case):
    """The lossy corpus streams: the JAX device path's record, within 1
    step of its pixels, and within tests/test_conformance_oracle.py's
    bounds of the reference decoder's pixels."""
    data = (CONFORMANCE / f"{case['name']}.jxl").read_bytes()
    jinfo, tinfo = {}, {}
    ref, _ = jcs.decode(data, device=True, decode_info=jinfo)
    got, _ = tcs.decode(data, device="cpu", decode_info=tinfo)
    assert tinfo["path"] == jinfo["path"], (tinfo, jinfo)
    _u8_close(got, ref, case["name"])
    oracle = np.load(CONFORMANCE / f"{case['name']}.npy")
    nc = min(got.shape[2], oracle.shape[2])
    d = got[:, :, :nc].astype(np.float64) - oracle[:, :, :nc]
    dist = float(case.get("encode_args", {}).get("distance", 1.0))
    if dist >= 4.0:
        limit, peak_limit = 0.5 * dist, int(2 * dist)
    elif "noise" in case["name"]:
        limit, peak_limit = 0.75, 2
    else:
        limit, peak_limit = 0.2, 2
    assert float(np.sqrt((d ** 2).mean())) < limit
    assert int(np.abs(d).max()) <= peak_limit


def test_decode_frames_on_device_matches_jax(monkeypatch):
    """A lossy animation (tests/test_animation.py's): every frame's path
    record equal to the JAX device path's, pixels within 1 step of it
    and of the port's host render."""
    rng = np.random.default_rng(2)
    frames = [np.clip(rng.normal(100 + 40 * i, 30, (128, 128, 3)), 0,
                      255).astype(np.uint8) for i in range(3)]
    stream = jcs.encode_animation(frames, lossless=False, distance=1.0)
    records = {"jax": [], "port": []}

    def spy(module, key):
        real = module.make_device_render

        def wrapped(fh, out=None, *args):
            records[key].append(out)
            return real(fh, out, *args)
        monkeypatch.setattr(module, "make_device_render", wrapped)

    spy(jtc, "jax")
    spy(ttc, "port")
    ref = [f for f, _ in jcs.decode_frames(stream, device=True)]
    got = [f for f, _ in tcs.decode_frames(stream, device="cpu")]
    host = [f for f, _ in tcs.decode_frames(stream, device=None)]
    assert len(got) == len(ref) == len(host) == 3
    assert [o["path"] for o in records["port"]] \
        == [o["path"] for o in records["jax"]] == ["device:u8"] * 3
    for i, (g, r, h) in enumerate(zip(got, ref, host)):
        _u8_close(g, r, f"frame {i}")
        _u8_close(g, h, f"frame {i} vs host")


def test_post_stage_falls_back_loudly(caplog):
    """A stage that needs the floats on the host (tone mapping) keeps the
    u8 write off the device: the frame's XYB comes back (device:xyb), as
    on the JAX path; a 4:2:0 stream then renders on the host, loudly."""
    data = _STREAMS["e5"]()
    jinfo, tinfo = {}, {}
    ref, _ = jcs.decode(data, device=True, decode_info=jinfo,
                        target_nits=100.0)
    got, _ = tcs.decode(data, device="cpu", decode_info=tinfo,
                        target_nits=100.0)
    assert tinfo["path"] == jinfo["path"] == "device:xyb"
    _u8_close(got, ref, "tone-mapped e5")
    data = _STREAMS["ycbcr420"]()
    tinfo = {}
    with caplog.at_level(logging.WARNING, logger="libjxl_tpu_torch.device"):
        tcs.decode(data, device="cpu", decode_info=tinfo, target_nits=100.0)
    assert tinfo["path"] == "host:chroma-subsampled"
    assert any("fell back" in r.message for r in caplog.records)


def test_tpu_codec_decode_matches_decode_tpu():
    """The port of decode_tpu: the first frame on the device, u8 out."""
    data = _STREAMS["e7"]()
    got, meta = ttc.decode(data, device="cpu")
    ref, _ = jtc.decode_tpu(data)
    assert (meta.size.xsize(), meta.size.ysize()) == (256, 256)
    _u8_close(got, ref, "decode")


def test_staged_batches_equal_the_jax_staging():
    """_prepare_batches stages the same arrays as the JAX package's."""
    from libjxl_tpu.io.bits import BitReader as JBitReader
    from libjxl_tpu.io.frame_header import FrameHeader as JFrameHeader
    from libjxl_tpu.vardct.frame import decode_vardct_frame as jdvf
    from libjxl_tpu_torch.io.bits import BitReader
    from libjxl_tpu_torch.io.frame_header import FrameHeader
    from libjxl_tpu_torch.vardct.frame import decode_vardct_frame

    data = _STREAMS["e7"]()
    staged = []
    for reader, header, dvf, prep in (
            (JBitReader, JFrameHeader, jdvf, jtc._prepare_batches),
            (BitReader, FrameHeader, decode_vardct_frame,
             ttc._prepare_batches)):
        r = reader(data)
        meta = (jcs if prep is jtc._prepare_batches
                else tcs).parse_codestream_header(r)
        fh = header(meta)
        fh.read(r)
        cap = {}

        def capture(state, cap=cap):
            cap["s"] = state
            state.restoration_done = state.device_output_done = True
        dvf(r, fh, render_fn=capture, want_qimg=True)
        st = cap["s"]
        # one-group streams: the dense image from the dict, as
        # stage_image assembles it
        ttc._dense_qimg(st)
        staged.append(prep(st, st.qimg))
    (je, jts, jm, jsp, jss, jcm), (te, tts, tsp, tss, tcm) = staged
    assert jts == tts and jss == tss and len(je) == len(te) > 0
    assert len(jsp) == len(tsp) > 0
    np.testing.assert_array_equal(jcm, tcm)
    # the JAX form's per-pixel DCT8 mask is class_map == 0, which the port
    # selects with instead
    np.testing.assert_array_equal(
        jm, np.repeat(np.repeat(tcm == 0, 8, 0), 8, 1).astype(np.float32))
    for a, b in zip(je + jsp, te + tsp):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", ["e5", "e7", "odd-true-size"])
def test_dense_qimg_places_every_block(name):
    """_dense_qimg's scatter puts each block of the per-block dict where
    its strategy's cells lie, as a block-by-block copy does."""
    from libjxl_tpu_torch.io.bits import BitReader
    from libjxl_tpu_torch.io.frame_header import FrameHeader
    from libjxl_tpu_torch.vardct import ac_strategy as acs
    from libjxl_tpu_torch.vardct.frame import decode_vardct_frame

    r = BitReader(_STREAMS[name]())
    fh = FrameHeader(tcs.parse_codestream_header(r))
    fh.read(r)
    cap = {}

    def capture(state):
        cap["s"] = state
        state.restoration_done = state.device_output_done = True
    decode_vardct_frame(r, fh, render_fn=capture, want_qimg=True)
    st = cap["s"]
    assert getattr(st, "qimg", None) is None and st.qblocks
    want = np.zeros((3, st.fd.ysize_blocks * 8, st.fd.xsize_blocks * 8),
                    dtype=np.int32)
    for (by, bx), blk in st.qblocks.items():
        s = int(st.strategy[by, bx])
        cx, cy = acs.COVERED_X[s], acs.COVERED_Y[s]
        want[:, by * 8:(by + cy) * 8, bx * 8:(bx + cx) * 8] = \
            np.asarray(blk).reshape(3, cy * 8, cx * 8)
    ttc._dense_qimg(st)
    assert st.qimg.dtype == np.int32
    np.testing.assert_array_equal(st.qimg, want)
    if name == "e7":
        assert len(np.unique(st.strategy[st.is_origin])) > 1


def test_cuda_device_without_a_card_raises():
    """"cuda", the entries' default, raises without a card: the decodes,
    encode_lossy at e3 (its device route), encode_lossy_streaming and
    decode_rows."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device path runs there")
    data = _STREAMS["epf3"]()
    img = _photo(64, 72, 8)
    for call in (lambda: tcs.decode(data, device="cuda"),
                 lambda: tcs.decode(data),
                 lambda: next(tcs.decode_frames(data)),
                 lambda: tcs.decode_batch([data, data]),
                 lambda: tcs.decode_batch([]),
                 lambda: ttc.decode(data),
                 lambda: tcs.encode_lossy(img, distance=1.0, effort=3),
                 lambda: ttc.encode_lossy_tpu(img),
                 lambda: tcs.encode_lossy_streaming(img),
                 lambda: next(tcs.decode_rows(data))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
