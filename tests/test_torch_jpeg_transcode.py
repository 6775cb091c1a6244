"""Losslessly recompressed JPEGs (chroma-subsampled YCbCr VarDCT frames)
decoded by libjxl_tpu_torch, held to the plain decode of the JPEG's own
coefficients (tests/reference/jpeg_transcode_ref.py) and to libjxl.

- the port's routes: decode(device="cpu") (the device program's plain
  twins, the native subsampled AC decode), decode(device=None) (the host
  render, the per-symbol AC decode) and decode_rows (the host strips):
  within 1 u8 step of the reference, under 1e-3 of the values off;
- the native subsampled AC decode (vardct/subsampled.
  decode_ac_bulk_native_sub) gives exactly the per-symbol route's
  coefficients (decode_ac_group_sub), on several threads;
- the reference within 1 step of libjxl's decode of libjxl's own
  transcode, where libjxl is installed (extras/oracle);
- block contexts conditioned on the DC, which libjxl's transcodes of
  JPEGs from about 1024x768 up signal: tests/data/transcode holds a
  1024x768 4:2:0 JPEG (libjpeg quality 90, through PIL) and libjxl 0.7's
  transcode of it (JxlEncoderAddJPEGFrame), two luma DC buckets.
"""

import functools
import io
import pathlib

import numpy as np
import pytest

from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.base.device import launch_counts
from libjxl_tpu_torch.extras import oracle
from libjxl_tpu_torch.io.bits import BitReader
from libjxl_tpu_torch.io.container import extract_codestream
from libjxl_tpu_torch.io.frame_header import FrameHeader
from libjxl_tpu_torch.jpeg.data import parse_jpeg
from libjxl_tpu_torch.jpeg.recompress import recompress_jpeg_vardct
from libjxl_tpu_torch.jpegli import encode_jpegli
from libjxl_tpu_torch.vardct.frame import decode_vardct_frame
from libjxl_tpu_torch.vardct.subsampled import dense_planes
from reference import jpeg_transcode_ref as ref

CONFORMANCE = pathlib.Path(__file__).resolve().parent / "data" / \
    "conformance"
DC_CONTEXTS = pathlib.Path(__file__).resolve().parent / "data" / \
    "transcode" / "dc_contexts_420"
# (mode, height, width): odd sizes, whose chroma extent ceil(size / 2)
# cuts a block, and a size of several groups
CASES = [(m, h, w) for m in ("420", "422")
         for h, w in ((77, 123), (201, 265), (520, 600))]
IDS = [f"{m}-{w}x{h}" for m, h, w in CASES]


def _photo(h, w, seed):
    """Smooth photo-like content, mild noise and a saturated red square,
    whose edges are where a chroma upsampler shows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (120 + 60 * np.sin(xx * 0.03) + 50 * np.cos(yy * 0.02 + 1)
           + rng.normal(0, 5, (h, w)))
    rgb = np.clip(np.stack([img, img * 0.9 + 10, img * 1.1 - 12], -1), 0,
                  255).astype(np.uint8)
    rgb[h // 3:h // 3 + h // 4, w // 3:w // 3 + w // 4] = (230, 10, 20)
    return rgb


def _pil_jpeg(img, subsampling):
    """A libjpeg quality-90 baseline JPEG (PIL): subsampling 2 is 4:2:0,
    1 is 4:2:2."""
    image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    image.fromarray(img).save(buf, "JPEG", quality=90,
                              subsampling=subsampling)
    return buf.getvalue()


@functools.lru_cache(maxsize=None)
def _jpeg(mode, h, w):
    """4:2:0 from the port's jpegli at quality 90 with the standard
    tables, 4:2:2 from libjpeg (jpegli here writes 4:2:0 and 4:4:4)."""
    img = _photo(h, w, h + w)
    if mode == "420":
        return encode_jpegli(img, quality=90, subsampling="420",
                             std_tables=True, adaptive=False,
                             optimize=False)
    return _pil_jpeg(img, 1)


@functools.lru_cache(maxsize=None)
def _transcode(mode, h, w):
    if mode == "libjxl":
        return DC_CONTEXTS.with_suffix(".jxl").read_bytes()
    return recompress_jpeg_vardct(_jpeg(mode, h, w))


def _source_jpeg(case):
    if case[0] == "libjxl":
        return DC_CONTEXTS.with_suffix(".jpg").read_bytes()
    return _jpeg(*case)


def _close(got, want, what):
    assert got.shape == want.shape and got.dtype == np.uint8, what
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1, (what, int(d.max()))
    assert (d != 0).mean() < 1e-3, (what, float((d != 0).mean()))


def _rows(data):
    strips = list(tcs.decode_rows(extract_codestream(data), device=None))
    assert [y for y, _ in strips] == sorted({y for y, _ in strips})
    return np.concatenate([r for _, r in strips], axis=0)


@pytest.mark.parametrize("route", ["cpu", "host", "rows"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_routes_match_the_plain_reference(case, route):
    """Each route's pixels within 1 step of the plain decode of the
    JPEG's coefficients, whose chroma is upsampled by libjxl's taps."""
    data = _transcode(*case)
    want = ref.decode_parsed(parse_jpeg(_jpeg(*case)))
    if route == "cpu":
        info = {}
        before = launch_counts().get("ac_native_sub", 0)
        got, _ = tcs.decode(data, device="cpu", decode_info=info)
        assert info["path"] == "device:u8-ycbcr"
        # a frame of one group reads its one section per symbol
        several = case[1] > 256 or case[2] > 256
        assert launch_counts().get("ac_native_sub", 0) - before \
            == int(several)
    elif route == "host":
        got, _ = tcs.decode(data, device=None)
    else:
        got = _rows(data)
    _close(got, want, (case, route))


def _state(data, want_qimg=False):
    r = BitReader(extract_codestream(data))
    fh = FrameHeader(tcs.parse_codestream_header(r))
    fh.read(r)
    cap = {}

    def capture(state):
        cap["state"] = state
        state.restoration_done = state.device_output_done = True

    decode_vardct_frame(r, fh, render_fn=capture, want_qimg=want_qimg,
                        num_threads=3)
    return cap["state"]


DC_CASE = ("libjxl", 768, 1024)


@pytest.mark.parametrize(
    "case", [c for c in CASES if c[1] > 100] + [DC_CASE],
    ids=[i for i, c in zip(IDS, CASES) if c[1] > 100] + ["libjxl-dc-ctx"])
def test_native_ac_equals_the_per_symbol_route(case, monkeypatch):
    """Every caller's subsampled frame takes the native decode (dense
    planes, no dicts); where it declines, the per-symbol route fills
    qblocks_sub: the same coefficients."""
    from libjxl_tpu_torch.vardct import subsampled

    data = _transcode(*case)
    native = _state(data)
    assert native.qimg_sub is not None and not any(native.qblocks_sub)
    assert _state(data, want_qimg=True).qimg_sub is not None
    monkeypatch.setattr(subsampled, "decode_ac_bulk_native_sub",
                        lambda *a: False)
    symbols = _state(data)
    assert getattr(symbols, "qimg_sub", None) is None
    for c, (a, b) in enumerate(zip(dense_planes(native),
                                   dense_planes(symbols))):
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape, c
        np.testing.assert_array_equal(a, b, err_msg=f"channel {c}")
        assert np.count_nonzero(a) > 0


@pytest.mark.parametrize("case", [c for c in CASES if c[1] > 100],
                         ids=[i for i, c in zip(IDS, CASES) if c[1] > 100])
def test_dc_groups_equal_the_jax_package(case):
    """The DC groups' fields, the AC metadata placed array-wise
    (vardct/subsampled._decode_ac_metadata), against the JAX package's
    block-by-block placement of the same stream."""
    from libjxl_tpu.api import codestream as jcs
    from libjxl_tpu.io.bits import BitReader as JBitReader
    from libjxl_tpu.io.frame_header import FrameHeader as JFrameHeader
    from libjxl_tpu.vardct import frame as jvf

    data = extract_codestream(_transcode(*case))
    r = JBitReader(data)
    fh = JFrameHeader(jcs.parse_codestream_header(r))
    fh.read(r)
    cap = {}

    def capture(state):
        cap["state"] = state
        state.restoration_done = state.device_output_done = True

    jvf.decode_vardct_frame(r, fh, render_fn=capture)
    ref, got = cap["state"], _state(data, True)
    for name in ("strategy", "is_origin", "raw_quant_field",
                 "epf_sharpness", "ytox_map", "ytob_map"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name), err_msg=name)
    for c in range(3):
        np.testing.assert_array_equal(got.dc_sub[c], ref.dc_sub[c])


def test_native_ac_rejects_a_corrupt_section():
    """A flipped byte inside an AC section: the native decode raises
    JXLError, as the per-symbol route does."""
    from libjxl_tpu_torch.base.status import JXLError

    data = bytearray(_transcode("420", 520, 600))
    data[len(data) - 200] ^= 0x5A
    with pytest.raises(JXLError):
        tcs.decode(bytes(data), device="cpu")


@pytest.mark.parametrize("route", ["cpu", "host", "rows", "symbols"])
def test_dc_conditioned_block_contexts(route, monkeypatch):
    """libjxl's transcode with block contexts conditioned on the DC
    (tests/data/transcode), decoded by each route (and by the per-symbol
    AC decode alone), within 1 step of the plain reference of its JPEG."""
    from libjxl_tpu_torch.vardct import subsampled

    data = _transcode(*DC_CASE)
    st = _state(data)
    assert st.block_ctx_map.num_dc_ctxs == 2
    assert set(np.unique(st.dc_idx)) == {0, 1}
    want = ref.decode_parsed(parse_jpeg(_source_jpeg(DC_CASE)))
    if route == "symbols":
        monkeypatch.setattr(subsampled, "decode_ac_bulk_native_sub",
                            lambda *a: False)
    if route == "cpu":
        info = {}
        got, _ = tcs.decode(data, device="cpu", decode_info=info)
        assert info["path"] == "device:u8-ycbcr"
    elif route == "rows":
        got = _rows(data)
    else:
        got, _ = tcs.decode(data, device=None)
    _close(got[:, :, :3], want, route)


def test_dc_contexts_are_allocated_before_the_dc_groups(monkeypatch):
    """state.dc_idx exists once the DC global section is read, before any
    DC group fills its blocks: DC groups may run on several threads, and
    an array made by the first of them could be replaced by another's,
    leaving a group's blocks in DC context 0."""
    from libjxl_tpu_torch.vardct import frame, subsampled

    seen = []
    store = frame.store_dc_context

    def checked(state, *a, **k):
        seen.append(getattr(state, "dc_idx", None))
        store(state, *a, **k)

    monkeypatch.setattr(subsampled, "store_dc_context", checked)
    st = _state(_transcode(*DC_CASE))
    assert seen and all(d is st.dc_idx for d in seen)


needs_oracle = pytest.mark.skipif(not oracle.available(),
                                  reason="libjxl is not installed")


@needs_oracle
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_dc_conditioned_transcodes_decode_as_libjxl(subsampling):
    """libjxl's transcodes at 1024x768, whose block contexts are
    conditioned on the DC of every channel at 4:4:4 and of luma at 4:2:2
    and 4:2:0, decoded by the host route as libjxl decodes them."""
    jpg = _pil_jpeg(_photo(768, 1024, 11), subsampling)
    data = oracle.encode_jpeg(jpg)
    assert _state(data).block_ctx_map.num_dc_ctxs > 1
    want, _ = oracle.decode(data)
    got, _ = tcs.decode(data, device=None)
    _close(got[:, :, :3], want[:, :, :3], subsampling)


@needs_oracle
@pytest.mark.parametrize("subsampling,h,w", [(2, 200, 264), (1, 201, 265),
                                             (2, 77, 123)])
def test_reference_matches_libjxl(subsampling, h, w):
    """libjxl's transcode of a libjpeg JPEG, decoded by libjxl, against
    the plain reference of the JPEG; 200 x 264 at 4:2:0 is a two-group
    frame with a saturated square."""
    jpg = _pil_jpeg(_photo(h, w, 3), subsampling)
    got, _ = oracle.decode(oracle.encode_jpeg(jpg))
    _close(got[:, :, :3], ref.decode_parsed(parse_jpeg(jpg)),
           (subsampling, h, w))


@needs_oracle
def test_reference_matches_libjxl_on_the_corpus_transcode():
    """tests/data/conformance/jpeg_recon.jxl (libjxl's transcode of
    jpeg_recon.jpg) decoded by libjxl."""
    got, _ = oracle.decode((CONFORMANCE / "jpeg_recon.jxl").read_bytes())
    jpg = (CONFORMANCE / "jpeg_recon.jpg").read_bytes()
    _close(got[:, :, :3], ref.decode_parsed(parse_jpeg(jpg)), "jpeg_recon")
