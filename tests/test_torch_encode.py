"""libjxl_tpu_torch's device encode against the JAX package's, on the CPU:
each stage of the port's ops/pipeline.py encode (libjxl_tpu/ops/pipeline.py
encode_step and what it calls, and tpu_codec's srgb2lin) on the same seeded
inputs, the whole step, encode_lossy_tpu's bytes, and encode_lossy's
device gate.

The JAX side runs its XLA forms, jitted (JAX_PLATFORMS=cpu). Floats are
held to rtol 1e-5 / atol 1e-6. Integers are exact, except a value whose
JAX float input lies within 1e-5 (relative) of its rounding, truncation
or dead-zone boundary (_assert_ints): the two sides' floats differ by an
ulp where they sum in another order or take another cube root.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libjxl_tpu.api import codestream as jcs
from libjxl_tpu.api import tpu_codec as jtc
from libjxl_tpu.ops import pipeline as jpl
from libjxl_tpu.vardct.frame import _deadzone_thresholds
from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.api import tpu_codec as ttc
from libjxl_tpu_torch.base.device import launch_counts
from libjxl_tpu_torch.ops import pipeline as tpl
from libjxl_tpu_torch.vardct.heuristics import gaborish_inverse_kernel

TOL = dict(rtol=1e-5, atol=1e-6)
BOUNDARY = 1e-5  # relative distance of a float from its boundary
GAB = gaborish_inverse_kernel(1.0).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def smooth(h, w, seed=0):
    """tests/test_tpu_codec.py's generator."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3))
    for i in range(3):
        img[:, :, i] = 128 + 80 * np.sin(xx / 17 + i) * np.cos(yy / 23 - i)
    img += rng.normal(0, 3, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def photo(h, w, seed):
    """Photo-like: smooth gradients, a diagonal texture and mild noise
    (bench.py's make_image at a smaller scale)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (120 + 60 * np.sin(xx * 0.03) + 50 * np.cos(yy * 0.02 + 1)
           + 20 * np.sin((xx + yy) * 0.1) + rng.normal(0, 5, (h, w)))
    rgb = np.stack([img, img * 0.9 + 10, img * 1.1 - 12], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _linear(img):
    """The encoder's linear RGB f32[3, H, W] of an sRGB u8 image (the JAX
    package's srgb2lin, so both sides start from the same floats)."""
    srgb = np.moveaxis(img.astype(np.float32) / 255.0, -1, 0)
    return np.array(jtc._jitted()[3](np.ascontiguousarray(srgb)))


def _boundary_dist(v, kind, thr=None):
    """Relative distance of each float v from the boundary its integer
    changes at: "round" (half-integers), "trunc" (integers) or "dz" (the
    dead zone |v| = thr, or a half-integer above it)."""
    v = np.asarray(v, dtype=np.float64)
    if kind == "trunc":
        b = np.round(v)
    else:
        b = np.floor(v) + 0.5
    d = np.abs(v - b) / np.maximum(np.abs(b), 1e-30)
    if kind == "dz":
        t = np.broadcast_to(np.asarray(thr, dtype=np.float64), v.shape)
        d = np.minimum(d, np.abs(np.abs(v) - t) / t)
    return d


def _assert_ints(got, ref, pre=None, kind="round", thr=None, also=None):
    """got == ref, except at values off by one whose JAX float `pre` lies
    within BOUNDARY of its boundary (or where `also` marks that a value
    they depend on differed)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    diff = got != ref
    if not diff.any():
        return
    assert pre is not None, f"{int(diff.sum())} values differ"
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1
    near = _boundary_dist(pre, kind, thr) <= BOUNDARY
    if also is not None:
        near = near | also
    bad = diff & ~near
    assert not bad.any(), (f"{int(bad.sum())} of {int(diff.sum())} differing"
                           f" values lie off their boundary: "
                           f"{np.asarray(pre)[bad][:5]}")


def _xyb_input(h, w, seed):
    """A photo's pre-sharpening XYB as the JAX package computes it."""
    return np.asarray(jax.jit(jpl.rgb_to_xyb_jax)(_linear(photo(h, w,
                                                                seed))))


def _dequant():
    """The default DCT8 dequant and quant-weight tables f32[3, 8, 8]."""
    from libjxl_tpu_torch.vardct.quant_weights import DequantMatrices

    m = DequantMatrices()
    return (np.stack([m.inv_matrix(0, c) for c in range(3)]).astype(
        np.float32), np.stack([m.dequant_matrix(0, c)
                               for c in range(3)]).astype(np.float32))


# ---------------------------------------------------------------- stages

def test_srgb2lin_matches_the_jax_form():
    rng = np.random.default_rng(1)
    srgb = rng.uniform(0, 1, (3, 40, 48)).astype(np.float32)
    srgb[0, 0, :6] = [0.0, 0.04, 0.04045, 0.0405, 0.5, 1.0]
    _close(tpl.srgb2lin(_t(srgb)), jtc._jitted()[3](srgb))


def test_block_layouts_match_the_jax_forms():
    rng = np.random.default_rng(2)
    img = rng.normal(0, 1, (3, 24, 40)).astype(np.float32)
    blocks = tpl.image_to_blocks(_t(img))
    np.testing.assert_array_equal(blocks.numpy(), jpl.image_to_blocks(img))
    np.testing.assert_array_equal(
        tpl.blocks_to_image(blocks).numpy(),
        jpl.blocks_to_image(jpl.image_to_blocks(img)))
    tiles = rng.integers(-20, 20, (2, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tpl._tile_to_blocks(_t(tiles), 11, 19).numpy(),
        jpl._tile_to_blocks(tiles, 11, 19))


def test_dct8_blocks_matches_the_jax_form():
    xyb = _xyb_input(48, 64, 3)
    blocks = np.asarray(jpl.image_to_blocks(xyb))
    _close(tpl.dct8_blocks(_t(blocks)), jax.jit(jpl.dct8_blocks)(blocks))


def test_rgb_to_xyb_matches_the_jax_form():
    rgb = _linear(photo(40, 56, 4))
    rgb[:, 0, :4] = [[0, 1, 0.5, 1e-4]] * 3
    _close(tpl.rgb_to_xyb(_t(rgb)), jax.jit(jpl.rgb_to_xyb_jax)(rgb))


def test_gaborish_inverse_matches_the_jax_form():
    xyb = _xyb_input(40, 48, 5)
    _close(tpl.gaborish_inverse(_t(xyb), GAB),
           jax.jit(lambda x: jpl.gaborish_inverse_jax(x, GAB))(xyb))


@jax.jit
def _jax_quant_field_pre(y, base_quant):
    """quant_field_jax's float before its round."""
    nby, nbx = y.shape[0] // 8, y.shape[1] // 8
    gy = jnp.abs(jnp.diff(y, axis=0, prepend=y[:1]))
    gx = jnp.abs(jnp.diff(y, axis=1, prepend=y[:, :1]))
    grad = (gy + gx).reshape(nby, 8, nbx, 8).mean(axis=(1, 3))
    mod = jnp.clip(1.6 - 0.35 * jnp.log1p(grad * 80.0), 0.55, 1.8)
    return base_quant * mod


@pytest.mark.parametrize("base_quant", [7.0, 23.0])
def test_quant_field_matches_the_jax_form(base_quant):
    y = _xyb_input(56, 72, 6)[1]
    qf, sharp = tpl.quant_field(_t(y), 7, 9, base_quant, 255)
    jqf, jsharp = jax.jit(functools.partial(
        jpl.quant_field_jax, nby=7, nbx=9, quant_max=255))(
            y, base_quant=np.float32(base_quant))
    _assert_ints(qf.numpy(), jqf,
                 _jax_quant_field_pre(y, np.float32(base_quant)))
    np.testing.assert_array_equal(sharp.numpy(), jsharp)


# calibrated distances: public 0.5, 1, 2 (mul and dampen branches), 6
@pytest.mark.parametrize("distance", [0.35, 0.7, 1.4, 2.8, 4.2])
def test_adaptive_quant_field_matches_the_jax_form(distance):
    xyb = _xyb_input(64, 80, 7)
    got = tpl.adaptive_quant_field(_t(xyb), 8, 10, distance)
    ref = jax.jit(functools.partial(jpl.adaptive_quant_field_jax, nby=8,
                                    nbx=10, distance=distance))(xyb)
    _close(got, ref)


@jax.jit
def _jax_cfl_pre(co):
    """fit_cfl_jax's floats before their round: (x, b)."""
    _, nby, nbx, _, _ = co.shape
    cm = co * jnp.ones((8, 8), jnp.float32).at[0, 0].set(0.0)
    t = cm.reshape(3, nby // 8, 8, nbx // 8, 8, 64)
    ys = t[1]
    denom = (ys * ys).sum(axis=(1, 3, 4)) + 1e-9
    return ((t[0] * ys).sum(axis=(1, 3, 4)) / denom * 84.0,
            ((t[2] * ys).sum(axis=(1, 3, 4)) / denom - 1.0) * 84.0)


def test_fit_cfl_matches_the_jax_form():
    rng = np.random.default_rng(8)
    co = np.array(jax.jit(jpl.dct8_blocks)(jpl.image_to_blocks(
        _xyb_input(128, 192, 9))))
    # chroma that follows luma, as CfL finds in photos
    co[0] += 0.08 * co[1] + rng.normal(0, 1e-3, co[0].shape)
    co[2] += 0.3 * co[1]
    x, b = tpl.fit_cfl(_t(co))
    jx, jb = jax.jit(jpl.fit_cfl_jax)(co)
    px, pb = _jax_cfl_pre(co)
    _assert_ints(x.numpy(), jx, px)
    _assert_ints(b.numpy(), jb, pb)
    assert np.abs(np.asarray(jx)).max() > 0, "the fit found no correlation"


# ----------------------------------------------------------- the whole step

@functools.partial(jax.jit, static_argnames=("color_factor",))
def _jax_prequant(xyb, dm_inv, dm, igs, xdm, bdm, qf, ytox, ytob,
                  color_factor=84.0):
    """encode_step_xyb's floats before the dead-zone quantizer, (x, y, b)
    f32[nby, nbx, 8, 8], with its own quantized Y for the CfL term."""
    _, h, w = xyb.shape
    nby, nbx = h // 8, w // 8
    co = jpl.dct8_blocks(jpl.image_to_blocks(xyb))
    scaled = (igs / qf.astype(jnp.float32))[:, :, None, None]
    x_cc = (0.0 + jpl._tile_to_blocks(ytox, nby, nbx).astype(jnp.float32)
            / color_factor)[:, :, None, None]
    b_cc = (1.0 + jpl._tile_to_blocks(ytob, nby, nbx).astype(jnp.float32)
            / color_factor)[:, :, None, None]
    vy = co[1] * dm_inv[1] / scaled
    thr = jnp.asarray(_deadzone_thresholds(1, 1, 1), dtype=jnp.float32)
    qy = jnp.where(jnp.abs(vy) < thr, 0.0, jnp.round(vy))
    dy = jpl.adjust_quant_bias_jax(qy, 1) * dm[1] * scaled
    vx = (co[0] - x_cc * dy) * dm_inv[0] / (scaled * xdm)
    vb = (co[2] - b_cc * dy) * dm_inv[2] / (scaled * bdm)
    return vx, vy, vb


def _assert_step(got, ref, xyb, scalars, dm_inv, dm, qf_pre=None):
    """The step's outputs (q, dc, qf, ytox, ytob, sharp): dc at TOL, the
    integers by _assert_ints against the JAX floats they round."""
    q, dc, qf, ytox, ytob, sharp = (t.numpy() for t in got)
    jq, jdc, jqf, jx, jb, jsharp = (np.asarray(a) for a in ref)
    _close(got[1], jdc)
    _assert_ints(qf, jqf, qf_pre, kind="trunc")
    np.testing.assert_array_equal(sharp, jsharp)
    nby, nbx = jqf.shape
    tby, tbx = -(-nby // 8), -(-nbx // 8)
    if jx.any() or jb.any():
        co = jax.jit(jpl.dct8_blocks)(jpl.image_to_blocks(xyb))
        co = jnp.pad(co, ((0, 0), (0, tby * 8 - nby), (0, tbx * 8 - nbx),
                          (0, 0), (0, 0)))
        px, pb = _jax_cfl_pre(co)
        _assert_ints(ytox, jx, px)
        _assert_ints(ytob, jb, pb)
    pre = _jax_prequant(xyb, dm_inv, dm, *scalars, jqf, jx, jb)
    qy_diff = q[1] != jq[1]
    for c in (1, 0, 2):
        _assert_ints(q[c], jq[c], pre[c], kind="dz",
                     thr=_deadzone_thresholds(1, 1, c),
                     also=None if c == 1 else qy_diff)


def _scalars(adaptive):
    """(inv_global_scale, x_dm_mult, b_dm_mult) and base_quant at d1's
    magnitudes (encode_lossy_tpu's host setup)."""
    igs = np.float32(8.716)
    return (igs, np.float32(1.0), np.float32(1.0)), \
        np.float32(0 if adaptive else 19)


@pytest.mark.parametrize("cfl", [True, False])
@pytest.mark.parametrize("qf_mode", ["adaptive", "uniform", "qf_in"])
def test_encode_step_xyb_matches_the_jax_step(qf_mode, cfl):
    """The streaming encoder's step from sharpened XYB, with the quant
    field from quant_field (adaptive), uniform, or the host's (qf_in);
    72x88 px, so the CfL grid pads to whole tiles."""
    xyb = np.asarray(jax.jit(lambda x: jpl.gaborish_inverse_jax(x, GAB))(
        _xyb_input(72, 88, 10)))
    dm_inv, dm = _dequant()
    (igs, xdm, bdm), bq = _scalars(qf_mode != "uniform")
    if qf_mode == "adaptive":
        bq = np.float32(19)
    qf_in = np.random.default_rng(11).integers(3, 40, (9, 11)).astype(
        np.int32) if qf_mode == "qf_in" else None
    adaptive = qf_mode != "uniform"
    ref = jax.jit(functools.partial(jpl.encode_step_xyb, adaptive=adaptive,
                                    cfl=cfl))(
        xyb, dm_inv, dm, igs, bq, xdm, bdm, qf_in=qf_in)
    got = tpl.encode_step_xyb(_t(xyb), _t(dm_inv), _t(dm), float(igs),
                              float(bq), float(xdm), float(bdm),
                              adaptive=adaptive, cfl=cfl,
                              qf_in=None if qf_in is None else _t(qf_in))
    qf_pre = None
    if qf_mode == "adaptive":
        qf_pre = _jax_quant_field_pre(xyb[1], bq) + 0.5
    _assert_step(got, ref, xyb, (igs, xdm, bdm), dm_inv, dm,
                 qf_pre=qf_pre)


@pytest.mark.parametrize("adaptive,cfl,gab", [
    (True, True, True), (False, True, True), (True, False, True),
    (True, True, False)],
    ids=["default", "uniform-qf", "no-cfl", "no-gaborish"])
def test_encode_step_matches_the_jax_step(adaptive, cfl, gab):
    """The one-shot step from linear RGB: XYB, the adaptive field on the
    pre-sharpening image (encode_lossy_tpu's route, distance given),
    inverse Gaborish, DCT, CfL, quantization."""
    rgb = _linear(photo(72, 88, 12))
    dm_inv, dm = _dequant()
    (igs, xdm, bdm), bq = _scalars(adaptive)
    distance = 0.7 if adaptive else None
    gk = GAB if gab else None
    ref = jax.jit(functools.partial(
        jpl.encode_step, adaptive=adaptive, cfl=cfl, distance=distance,
        gab_kernel=gk))(rgb, dm_inv, dm, inv_global_scale=igs,
                        base_quant=bq, x_dm_mult=xdm, b_dm_mult=bdm)
    got = tpl.encode_step(_t(rgb), _t(dm_inv), _t(dm), gk, float(igs),
                          float(bq), float(xdm), float(bdm),
                          adaptive=adaptive, cfl=cfl, distance=distance)
    xyb0 = jax.jit(jpl.rgb_to_xyb_jax)(rgb)
    xyb = jax.jit(lambda x: jpl.gaborish_inverse_jax(x, GAB))(xyb0) \
        if gab else xyb0
    qf_pre = None
    if adaptive:
        field = jax.jit(functools.partial(jpl.adaptive_quant_field_jax,
                                          nby=9, nbx=11,
                                          distance=distance))(xyb0)
        qf_pre = np.asarray(field) * igs + np.float32(0.5)
    _assert_step(got, ref, np.asarray(xyb), (igs, xdm, bdm), dm_inv, dm,
                 qf_pre=qf_pre)


# ------------------------------------------------------ encode_lossy_tpu

IMAGES = {"smooth-96x80": lambda: smooth(96, 80),
          "photo-256": lambda: photo(256, 256, 13),
          "photo-203x229": lambda: photo(203, 229, 14)}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_encode_lossy_tpu_writes_the_jax_and_host_bytes(name):
    """encode_lossy_tpu(device="cpu") writes the JAX package's
    encode_lossy_tpu bytes, which equal its host e3 encoder's
    (tests/test_tpu_codec.py), and the port's host e3 encode; no kernel
    launches (the encode has none)."""
    img = IMAGES[name]()
    before = launch_counts()
    out = ttc.encode_lossy_tpu(img, distance=1.0, device="cpu")
    assert launch_counts() == before
    assert out == jtc.encode_lossy_tpu(img, distance=1.0)
    assert out == tcs.encode_lossy(img, distance=1.0, effort=3, device=None)


@pytest.mark.parametrize("kw", [dict(adaptive_quant=False), dict(cfl=False),
                                dict(gaborish=False, epf=0), dict(epf=3),
                                dict(distance=2.5)],
                         ids=["uniform-qf", "no-cfl", "no-filters", "epf3",
                              "d2.5"])
def test_encode_lossy_tpu_options_write_the_jax_bytes(kw):
    img = photo(96, 112, 15)
    assert ttc.encode_lossy_tpu(img, device="cpu", **kw) \
        == jtc.encode_lossy_tpu(img, **kw)


# --------------------------------------------------- encode_lossy's gate

def test_encode_lossy_device_route_writes_the_jax_device_bytes():
    """At e3 with no special features: device="cpu" is the JAX package's
    device route, device=None its host route."""
    img = photo(80, 72, 16)
    assert tcs.encode_lossy(img, distance=1.0, effort=3, device="cpu") \
        == jcs.encode_lossy(img, distance=1.0, effort=3, device=True)
    assert tcs.encode_lossy(img, distance=1.0, effort=2, device=None) \
        == jcs.encode_lossy(img, distance=1.0, effort=2, device=False)


def _rgba(img):
    return np.dstack([img, np.full(img.shape[:2], 200, np.uint8)])


GATED = {
    "e4": dict(effort=4),
    "e5": dict(effort=5),
    "icc": dict(effort=3, icc="srgb"),
    "photon-noise": dict(effort=3, photon_noise_iso=800),
    "progressive": dict(effort=3, progressive=2),
    "resampling": dict(effort=3, resampling=2),
    "stats": dict(effort=3, stats={}),
    "rgba": dict(effort=3, image=_rgba),
    "u16": dict(effort=3, image=lambda a: a.astype(np.uint16) * 257),
}


@pytest.mark.parametrize("case", sorted(GATED))
def test_encode_lossy_outside_the_gate_is_the_host_encode(case,
                                                          monkeypatch):
    """Efforts above 3 and the special features take the host encode,
    with the JAX package's host bytes. A featured e3 encode runs no device
    stage whatever the device (the default "cuda" too, here with no card:
    the device is resolved only where a stage runs on it). At e4 and e5
    the AC-strategy tile costs run on the device: device=None is the JAX
    package's host encode, device="cpu" its device forms (its accelerator
    probe patched to read True; tests/test_torch_heuristics.py)."""
    kw = dict(GATED[case])
    img = kw.pop("image", lambda a: a)(photo(72, 64, 17))
    if kw.get("icc") == "srgb":
        from libjxl_tpu_torch.extras import cms

        kw["icc"] = cms.make_rgb_profile(
            ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06)), gamma=2.2)
    jkw = {k: ({} if k == "stats" else v) for k, v in kw.items()}
    ref = jcs.encode_lossy(img, distance=1.0, device=True, **jkw)
    if kw["effort"] >= 4:
        assert tcs.encode_lossy(img, distance=1.0, device=None, **kw) == ref
        monkeypatch.setattr(jtc, "accelerator_available", lambda: True)
        ref = jcs.encode_lossy(img, distance=1.0, device=True, **jkw)
        assert tcs.encode_lossy(img, distance=1.0, device="cpu", **kw) \
            == ref
        return
    assert tcs.encode_lossy(img, distance=1.0, device="cpu", **kw) == ref
    kw = {k: ({} if k == "stats" else v) for k, v in kw.items()}
    assert tcs.encode_lossy(img, distance=1.0, **kw) == ref
