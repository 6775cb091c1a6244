"""The port's copies of the host layers (libjxl_tpu_torch/{io, entropy,
modular, vardct, render, api/codestream, native_ext}) against the JAX
package's, which they were copied from: the same streams give the same
decode state and the same pixels, and the same images give the same
bytes, exactly.

The JAX package's side runs its host routes (device=False); the port has
no other. Both build their native C at first use.
"""

import enum
import json
import pathlib

import numpy as np
import pytest

from libjxl_tpu.api import codestream as jcs
from libjxl_tpu.io.bits import BitReader as JBitReader
from libjxl_tpu.io.frame_header import FrameHeader as JFrameHeader
from libjxl_tpu.render import pipeline as jrp
from libjxl_tpu.vardct import frame as jvf
from libjxl_tpu_torch import native_ext
from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.io.bits import BitReader as TBitReader
from libjxl_tpu_torch.io.frame_header import FrameHeader as TFrameHeader
from libjxl_tpu_torch.render import pipeline as trp
from libjxl_tpu_torch.vardct import frame as tvf

CONFORMANCE = pathlib.Path(__file__).resolve().parent / "data" / \
    "conformance"


def _corpus_cases():
    """Every stream of the conformance corpus: lossless and lossy
    modular, VarDCT, and the chroma-subsampled JPEG transcode."""
    cases = json.loads((CONFORMANCE / "manifest.json").read_text())["cases"]
    return sorted(c["name"] for c in cases)


def _image(n, seed, noise=3.0):
    """tests/test_ans_kernel.py's generator: n x n, smooth plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    img = (128 + 50 * np.sin(xx * 0.013) + 40 * np.cos(yy * 0.009)
           + rng.normal(0, noise, (n, n)))
    rgb = np.stack([img, img * 0.92 + 8, img * 1.05 - 9], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def generated():
    """Two 512^2 d1/e3 streams (4 AC groups each) from the JAX package's
    encoder: the default filters (Gaborish, 2 EPF passes) and epf=3."""
    return {epf: jcs.encode_lossy(_image(512, 11 + i), distance=1.0,
                                  effort=3, device=False, epf=epf)
            for i, epf in enumerate((None, 3))}


def _state(data, codestream, reader, frame_header, vardct_frame):
    r = reader(data)
    meta = codestream.parse_codestream_header(r)
    fh = frame_header(meta)
    fh.read(r)
    cap = {}

    def capture(state):
        cap["state"] = state
        state.restoration_done = True
        state.device_output_done = True

    vardct_frame.decode_vardct_frame(r, fh, render_fn=capture,
                                     want_qimg=True)
    return cap["state"]


def _fields(obj):
    """An object's attributes: its __dict__ and its __slots__."""
    out = dict(getattr(obj, "__dict__", {}))
    for cls in type(obj).__mro__:
        for name in getattr(cls, "__slots__", ()):
            if hasattr(obj, name):
                out[name] = getattr(obj, name)
    return out


def _assert_same(a, b, what, seen=None):
    """a (the JAX package's) and b (the port's) hold the same values:
    arrays, containers and scalars exactly, enum members by name and
    value, and any other object attribute by attribute, its class by name.
    A type it does not know fails."""
    seen = set() if seen is None else seen
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}[{k!r}]", seen)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]", seen)
    elif isinstance(a, enum.Enum):
        assert (a.name, a.value) == (b.name, b.value), what
    elif a is None or isinstance(a, (bool, int, float, str, bytes,
                                     np.generic)):
        assert type(a) is type(b), what
        assert a == b or (a != a and b != b), what     # NaN equals NaN
    elif not callable(a) and (hasattr(a, "__dict__")
                              or hasattr(type(a), "__slots__")):
        assert type(a).__name__ == type(b).__name__, what
        if id(a) in seen:
            return
        seen.add(id(a))
        fa, fb = _fields(a), _fields(b)
        assert fa.keys() == fb.keys(), what
        for k in fa:
            _assert_same(fa[k], fb[k], f"{what}.{k}", seen)
    else:
        assert False, f"{what}: cannot compare a {type(a).__name__}"


@pytest.mark.parametrize("epf", [None, 3])
def test_decode_state_equals_the_jax_package(generated, epf):
    """decode_vardct_frame(..., want_qimg=True): the whole state, field by
    field and into every object it holds (qimg, quant field, DC, AC
    strategy, CfL maps, EPF sharpness, the coefficient orders, the
    quantizer, the frame header, the entropy codes), then the EPF sigma
    both packages compute from it."""
    data = generated[epf]
    js = _state(data, jcs, JBitReader, JFrameHeader, jvf)
    ts = _state(data, tcs, TBitReader, TFrameHeader, tvf)
    assert js.qimg is not None and js.qimg.shape == (3, 512, 512)
    _assert_same(js, ts, "state")
    assert js.fh.loop_filter.epf_iters == (3 if epf == 3 else 2)
    sig = [rp.compute_sigma(s.fh.loop_filter,
                            s.quantizer.global_scale_float,
                            s.raw_quant_field, s.epf_sharpness)
           for rp, s in ((jrp, js), (trp, ts))]
    _assert_same(*sig, "sigma")


@pytest.mark.parametrize("name", _corpus_cases())
def test_host_decode_conformance_equals_the_jax_package(name):
    """Byte for byte, but the JPEG transcode: the JAX package repeats its
    chroma samples where libjxl interpolates them, so that one is held to
    the plain decode of jpeg_recon.jpg's coefficients
    (tests/reference/jpeg_transcode_ref.py), within 1 u8 step and under
    1e-3 of the values off."""
    data = (CONFORMANCE / f"{name}.jxl").read_bytes()
    out, _ = tcs.decode(data, device=None)
    if name == "jpeg_recon":
        from libjxl_tpu_torch.jpeg.data import parse_jpeg
        from reference import jpeg_transcode_ref

        ref = jpeg_transcode_ref.decode_parsed(parse_jpeg(
            (CONFORMANCE / "jpeg_recon.jpg").read_bytes()))
        assert out.dtype == ref.dtype and out.shape == ref.shape
        d = np.abs(out.astype(int) - ref.astype(int))
        assert d.max() <= 1 and (d != 0).mean() < 1e-3
        return
    ref, _ = jcs.decode(data, device=False)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("epf", [None, 3])
def test_host_decode_generated_equals_the_jax_package(generated, epf):
    data = generated[epf]
    ref, _ = jcs.decode(data, device=False)
    out, _ = tcs.decode(data, device=None)
    assert out.dtype == np.uint8 and out.shape == (512, 512, 3)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape,seed,epf", [((96, 128), 1, None),
                                            ((300, 270), 2, 3)])
def test_encode_lossy_writes_the_jax_package_bytes(shape, seed, epf):
    """encode_lossy(effort=3) of a one-group and a four-group image whose
    sides are not multiples of 8."""
    img = _image(max(shape), seed)[:shape[0], :shape[1]]
    ref = jcs.encode_lossy(img, distance=1.0, effort=3, device=False,
                           epf=epf)
    out = tcs.encode_lossy(img, distance=1.0, effort=3, epf=epf,
                           device=None)
    assert out == ref


@pytest.mark.parametrize("effort", [5, 7])
def test_encode_lossy_at_higher_efforts_writes_the_jax_package_bytes(effort):
    """The default effort (5: the learned modular DC tree, the AC
    strategy search) and 7 (the butteraugli quant refinement), both on the
    host (device=None)."""
    img = _image(160, 21)[:, :136]
    ref = jcs.encode_lossy(img, distance=1.0, effort=effort, device=False)
    assert tcs.encode_lossy(img, distance=1.0, effort=effort,
                            device=None) == ref


def test_encode_lossless_learned_tree_writes_the_jax_package_bytes():
    """Effort 7 learns the MA tree (modular/learn.py)."""
    img = _image(96, 22)[:80]
    ref = jcs.encode_lossless(img, effort=7)
    assert tcs.encode_lossless(img, effort=7) == ref


def _gated_streams():
    """A stream with an ICC profile and one with splines, each from the
    port's own encoder."""
    from libjxl_tpu_torch.extras import cms
    from libjxl_tpu_torch.render.splines import Spline

    img = _image(96, 23)
    icc = cms.make_rgb_profile(((0.64, 0.33), (0.21, 0.71), (0.15, 0.06)),
                               gamma=2.2)
    color = np.zeros((3, 32))
    color[:, 0] = (0.2, 0.5, 0.4)
    sigma = np.zeros(32)
    sigma[0] = 2.0
    spline = Spline(np.array([[20.0, 20.0], [40.0, 35.0], [70.0, 60.0]]),
                    color, sigma)
    return {"icc": tcs.encode_lossy(img, distance=1.0, effort=3, icc=icc,
                                    device=None),
            "splines": tcs.encode_lossy(img, distance=1.0,
                                        splines=[spline], device=None)}


@pytest.mark.parametrize("kind", ["icc", "splines"])
def test_batch_gates_raise_jxlerror_with_the_jax_reasons(kind):
    """prepare_batch and prepare_batch_entropy refuse an ICC stream and a
    spline stream with JXLError and the JAX package's reasons, so callers
    fall back; decode_batch_entropy takes its host-entropy fallback, whose
    own gate then refuses the stream, as the JAX package's does."""
    from libjxl_tpu.api import tpu_codec as jtc
    from libjxl_tpu_torch.api import tpu_codec as ttc
    from libjxl_tpu_torch.base.status import JXLError

    data = _gated_streams()[kind]
    for port, jax_fn in ((ttc.prepare_batch, jtc.prepare_tpu_batch),
                         (ttc.prepare_batch_entropy,
                          jtc.prepare_tpu_batch_entropy)):
        with pytest.raises(Exception) as jerr:
            jax_fn([data])
        with pytest.raises(JXLError) as err:
            port([data])
        assert type(jerr.value).__name__ == "JXLError"
        assert str(err.value) == str(jerr.value)
    with pytest.raises(JXLError) as err:
        ttc.decode_batch_entropy([data], "cpu")
    reason = str(jerr.value)
    assert f"device-entropy fallback: {reason}" in err.value.__notes__
    assert "CMS output stage" in reason if kind == "icc" \
        else "no raw AC capture" in reason


def test_decode_batch_entropy_falls_back_to_host_entropy():
    """A one-group stream has no raw AC sections: the device-entropy path
    falls back to the host-entropy batch, which decodes it."""
    from libjxl_tpu_torch.api import tpu_codec as ttc

    data = tcs.encode_lossy(_image(64, 24), distance=1.0, effort=3,
                            device=None)
    imgs, info = ttc.decode_batch_entropy([data], "cpu")
    assert info == {"path": "host_entropy",
                    "fallback": "batch decode: no raw AC capture"}
    ref, _ = jcs.decode(data, device=False)
    assert np.abs(imgs[0].astype(int) - ref.astype(int)).max() <= 1


def test_native_library_builds_in_the_build_dir():
    """The port's own native library: built from libjxl_tpu_torch/native
    into build/libjxl_tpu_torch/, under a hashed name."""
    lib = native_ext.get_lib()
    assert lib is not None
    so = native_ext.library_path()
    assert so.exists() and so.parent == native_ext.BUILD_DIR
    assert so.parent.parts[-2:] == ("build", "libjxl_tpu_torch")
    assert pathlib.Path(lib._name) == so
