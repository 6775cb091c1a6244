"""libjxl_tpu_torch's bounded-memory decode (vardct/low_memory.py,
codestream.decode_rows) against the JAX package's on the CPU.

Host strips (device=None): byte-equal to the JAX package's decode_rows on
tests/test_low_memory.py's streams, but the chroma-subsampled ones, held
to libjxl (the JAX package's chroma upsampling is not libjxl's). Device
strips (device="cpu": the kernels' plain twins on each haloed strip):
within 1 u8 step of the JAX package's device strips and of the port's
whole-image decode(..., device="cpu"). Unsupported features raise the
same JXLError.
"""

import numpy as np
import pytest

from libjxl_tpu.api import codestream as jcs
from libjxl_tpu.io.bits import BitReader as JBitReader
from libjxl_tpu.io.frame_header import FrameHeader as JFrameHeader
from libjxl_tpu.vardct.low_memory import decode_vardct_strips as jstrips
from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.base.device import launch_counts
from libjxl_tpu_torch.base.status import JXLError
from libjxl_tpu_torch.io.bits import BitReader
from libjxl_tpu_torch.io.frame_header import FrameHeader
from libjxl_tpu_torch.vardct.low_memory import decode_vardct_strips


def _image(h, w, seed=5):
    """tests/test_low_memory.py's generator."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(yy * 0.4 + xx * 0.1) % 256, (xx * 0.6) % 256,
                    ((yy - xx) * 0.3) % 256], -1)
    return np.clip(img + rng.normal(0, 6, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _assemble(rows):
    out, h = [], 0
    for y0, r in rows:
        assert y0 == h  # strips arrive in order, no gaps
        out.append(r)
        h += r.shape[0]
    return np.concatenate(out, axis=0)


def _same_as_jax(stream):
    """The port's host strips equal the JAX package's, byte for byte."""
    out = _assemble(tcs.decode_rows(stream, device=None))
    ref = _assemble(jcs.decode_rows(stream))
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    return out


def _encode(img, **kw):
    return jcs.encode_lossy(img, distance=kw.pop("distance", 1.0),
                            effort=3, device=False, **kw)


def _ycbcr(mode):
    """tests/test_low_memory.py's subsampled YCbCr stream."""
    from libjxl_tpu.api.codestream import (CodecMetadata, SizeHeader,
                                           write_codestream_header)
    from libjxl_tpu.io.bits import BitWriter
    from libjxl_tpu.io.frame_header import (
        CT_YCBCR, ENC_VARDCT, FLAG_SKIP_ADAPTIVE_DC_SMOOTHING, FT_REGULAR)
    from libjxl_tpu.vardct.frame import rgb_to_ycbcr
    from libjxl_tpu.vardct.subsampled import encode_vardct_subsampled

    img = _image(600, 320, seed=17)
    meta = CodecMetadata()
    meta.size = SizeHeader().set(320, 600)
    meta.m.all_default = False
    meta.m.xyb_encoded = False
    w = BitWriter()
    write_codestream_header(w, meta)
    fh = JFrameHeader(meta)
    fh.all_default = False
    fh.frame_type = FT_REGULAR
    fh.encoding = ENC_VARDCT
    fh.color_transform = CT_YCBCR
    fh.chroma_subsampling.channel_mode = mode
    fh.flags = FLAG_SKIP_ADAPTIVE_DC_SMOOTHING
    fh.loop_filter.all_default = False
    fh.loop_filter.gab = False
    fh.loop_filter.epf_iters = 0
    hs = [fh.chroma_subsampling.hshift(c) for c in range(3)]
    vs = [fh.chroma_subsampling.vshift(c) for c in range(3)]
    ycbcr = rgb_to_ycbcr(np.moveaxis(img.astype(np.float64) / 255, -1, 0))

    def ds(p, fy, fx):
        h2, w2 = p.shape[0] // fy * fy, p.shape[1] // fx * fx
        return p[:h2, :w2].reshape(h2 // fy, fy, w2 // fx, fx).mean(
            axis=(1, 3))

    encode_vardct_subsampled(
        w, [ds(ycbcr[c], 1 << vs[c], 1 << hs[c]) for c in range(3)], fh,
        distance=1.0)
    return w.get_bytes()


def _splines():
    from libjxl_tpu.render.splines import Spline

    rng = np.random.default_rng(3)
    img = np.clip(np.full((600, 300, 3), 128.0)
                  + rng.normal(0, 4, (600, 300, 3)), 0,
                  255).astype(np.uint8)
    pts = np.cumsum(rng.integers(10, 60, size=(8, 2)), axis=0) + 12.0
    pts[:, 0] = np.clip(pts[:, 0], 0, 280)
    pts[:, 1] = np.clip(pts[:, 1] * 2.0, 0, 580)
    color = np.zeros((3, 32))
    color[:, 0] = (0.2, 0.6, 0.3)
    sigma = np.zeros(32)
    sigma[0] = 2.5
    return _encode(img, splines=[Spline(pts, color, sigma)])


def _patches():
    rng = np.random.default_rng(5)
    base = np.clip(np.full((600, 280, 3), 200.0)
                   + rng.normal(0, 3, (600, 280, 3)), 0,
                   255).astype(np.uint8)
    sheet = np.zeros((24, 24, 3), np.uint8)
    sheet[4:20, 4:20] = (40, 180, 90)
    return jcs.encode_with_patches(
        base, sheet, [(0, 0, 24, 24,
                       [(30, 100), (200, 250), (100, 500), (40, 245)])],
        distance=1.0)


def _hdr16():
    rng = np.random.default_rng(4)
    base = (30000 + 12000 * np.sin(np.arange(600)[:, None] * 0.01)
            + 9000 * np.cos(np.arange(320)[None, :] * 0.013)
            + rng.normal(0, 800, (600, 320)))
    img = np.clip(np.stack([base, base * 0.92, base * 1.05], -1),
                  0, 65535).astype(np.uint16)
    return _encode(img, progressive=2)


def _alpha():
    rng = np.random.default_rng(7)
    alpha = np.clip(np.linspace(0, 255, 600)[:, None]
                    + rng.normal(0, 10, (600, 300)), 0, 255).astype(np.uint8)
    return _encode(np.dstack([_image(600, 300, seed=7), alpha]))


STREAMS = {
    "600x520": lambda: _encode(_image(600, 520)),
    "256x256-d2": lambda: _encode(_image(256, 256), distance=2.0),
    "64x48": lambda: _encode(_image(64, 48)),
    "257x1030-d1.5": lambda: _encode(_image(257, 1030), distance=1.5),
    "noise": lambda: _encode(_image(700, 300), photon_noise_iso=1600),
    "progressive2": lambda: _encode(_image(600, 330), progressive=2),
    "progressive3": lambda: _encode(_image(600, 330), progressive=3),
    "upsampled2": lambda: _encode(_image(520, 280, seed=8), resampling=2),
    "upsampled4": lambda: _encode(_image(520, 280, seed=8), resampling=4),
    "progressive-upsampled": lambda: _encode(_image(600, 256, seed=12),
                                             resampling=2, progressive=2),
    "ycbcr420": lambda: _ycbcr([0, 1, 0]),
    "ycbcr422": lambda: _ycbcr([0, 2, 0]),
    "hdr16-progressive": _hdr16,
    "alpha": _alpha,
    "splines": _splines,
    "patches": _patches,
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_host_strips_equal_the_jax_strips(name):
    """Byte for byte, but the chroma-subsampled streams: the JAX package
    repeats chroma samples where libjxl interpolates them, so those are
    held to libjxl's decode of the stream (the port's whole-image host
    decode where libjxl is not installed), within 1 u8 step and under
    1e-3 of the values off: a strip upsamples from one chroma row of each
    neighbouring strip."""
    if name not in ("ycbcr420", "ycbcr422"):
        _same_as_jax(STREAMS[name]())
        return
    from libjxl_tpu_torch.extras import oracle

    stream = STREAMS[name]()
    out = _assemble(tcs.decode_rows(stream, device=None))
    ref = oracle.decode(stream)[0][:, :, :3] if oracle.available() \
        else tcs.decode(stream, device=None)[0]
    assert out.dtype == ref.dtype and out.shape == ref.shape
    d = np.abs(out.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d != 0).mean() < 1e-3


def _device_strips(decode_strips, reader, header, stream, **kw):
    r = reader(stream)
    fh = header(tcs.parse_codestream_header(r) if reader is BitReader
                else jcs.parse_codestream_header(r))
    fh.read(r)
    strips = list(decode_strips(r, fh, **kw))
    return strips


@pytest.mark.parametrize("shape,kw", [
    ((600, 520), {}), ((257, 1030), {}), ((300, 200), dict(epf=3)),
    ((200, 264), dict(gaborish=False, epf=0)), ((64, 48), {})],
    ids=["600x520", "257x1030", "epf3", "no-filters", "one-group"])
def test_device_strips_track_the_jax_device_strips(shape, kw):
    """decode_vardct_strips(device="cpu") renders u8 strips (the plain
    twins on each 64-px-haloed composite) within 1 u8 step of the JAX
    package's device strips and of the port's whole-image device decode;
    the twins launch no kernel, and the frame's AC-global section is read
    in C once."""
    stream = jcs.encode_lossy(_image(*shape), distance=1.0, effort=3,
                              device=False, **kw)
    before = launch_counts()
    got = _device_strips(decode_vardct_strips, BitReader, FrameHeader,
                         stream, device="cpu")
    assert {k: n - before.get(k, 0) for k, n in launch_counts().items()
            if n != before.get(k, 0)} == {"ac_global_native": 1}
    ref = _device_strips(jstrips, JBitReader, JFrameHeader, stream,
                         device=True)
    assert [y for y, _ in got] == [y for y, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        assert a.dtype == np.uint8 and a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    whole, _ = tcs.decode(stream, device="cpu")
    rows = _assemble(tcs.decode_rows(stream, device="cpu"))
    assert rows.shape == whole[:, :, :3].shape
    assert np.abs(rows.astype(int) - whole[:, :, :3].astype(int)).max() <= 1


@pytest.mark.parametrize("name", ["e5", "noise", "hdr16-progressive"])
def test_streams_outside_the_device_scope_take_the_host_strips(name):
    """An e5 stream (AC strategies besides DCT8), a noise stream and a
    16-bit stream: decode_rows(device="cpu") gives decode_rows(device=
    None)'s rows exactly."""
    stream = jcs.encode_lossy(_image(300, 280), distance=1.0, effort=5,
                              device=False) if name == "e5" \
        else STREAMS[name]()
    np.testing.assert_array_equal(
        _assemble(tcs.decode_rows(stream, device="cpu")),
        _assemble(tcs.decode_rows(stream, device=None)))


def _same_error(stream):
    with pytest.raises(Exception) as jerr:
        list(jcs.decode_rows(stream))
    for device in (None, "cpu"):
        with pytest.raises(JXLError) as err:
            list(tcs.decode_rows(stream, device=device))
        assert type(jerr.value).__name__ == "JXLError"
        assert str(err.value) == str(jerr.value)


def test_unsupported_features_raise_the_jax_errors():
    img = _image(128, 128)
    _same_error(_encode(img, resampling=2, photon_noise_iso=1600))
    _same_error(jcs.encode_lossless(img))


def test_truncated_stream_raises_the_jax_errors():
    stream = _encode(_image(300, 280))
    for cut in (50, len(stream) // 2, len(stream) - 10):
        _same_error(stream[:cut])
