"""libjxl_tpu_torch's block-layout device decode against the JAX package
on the CPU: ops/pipeline's decode_xyb, decode_pixels and decode_render
against the JAX XLA forms, ops/kernels' routes decode_pixels_hybrid and
decode_render_blocks (on CPU tensors their plain twins) against the JAX
Pallas route in interpret mode, ops/xyb.make_torch_xyb against
make_jax_xyb, and entry.entry(device="cpu") against
__graft_entry__.entry().

Bounds: the XLA forms at rtol 1e-5 / atol 1e-3 (tests/test_tpu_pipeline.py),
the Pallas route at rtol 5e-3 / atol 1e-3 (tests/test_pallas.py). XLA's
IDCT on the CPU sums in another order than the port's einsum. On
tests/test_pallas.py's inputs (every AC in [-15, 15], a dequant table of
0.5-2, so XYB in the thousands) the linear RGB is held to the XYB bound
carried through xyb_to_rgb's cubes and matrix (_rgb_tol), as
tests/test_torch_sharding.py holds the full decode: there the matrix
cancels terms of 1e14 and an ulp of XYB moves RGB by 3e-3 of itself.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libjxl_tpu.ops import pipeline as jpl
from libjxl_tpu.ops.pallas_kernels import decode_pixels_hybrid as jhybrid
from libjxl_tpu.ops.xyb import make_jax_xyb
from libjxl_tpu.render.pipeline import _sad_mul_map, gaborish_kernel
from libjxl_tpu.vardct.quant_weights import library_tables
from libjxl_tpu_torch import entry as tentry
from libjxl_tpu_torch.base.device import launch_counts
from libjxl_tpu_torch.ops import kernels
from libjxl_tpu_torch.ops import pipeline as tpl
from libjxl_tpu_torch.ops.xyb import make_torch_xyb

ROOT = pathlib.Path(__file__).resolve().parents[1]
XLA_TOL = dict(rtol=1e-5, atol=1e-3)
PALLAS_TOL = dict(rtol=5e-3, atol=1e-3)
CS = (40.0, 5.0, 3.5)
IGS = 8.0  # a d1 stream's inv_global_scale (XYB near a photo's)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pallas_inputs(seed=3, nby=16, nbx=16):
    """tests/test_pallas.py's inputs: qf 48, per-tile CfL maps, a random
    dequant table."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-15, 15, (3, nby, nbx, 8, 8)).astype(np.int32)
    qf = np.full((nby, nbx), 48, dtype=np.int32)
    dc = rng.normal(0, .2, (3, nby, nbx)).astype(np.float32)
    t = -(-nby // 8), -(-nbx // 8)
    ytox = rng.integers(-10, 10, t).astype(np.int32)
    ytob = rng.integers(-10, 10, t).astype(np.int32)
    dm = rng.uniform(0.5, 2.0, (3, 8, 8)).astype(np.float32)
    return q, qf, dc, ytox, ytob, dm


def _render_inputs(seed, nby=16, nbx=16):
    """A d1 stream's magnitudes (with IGS): sparse small AC, qf of a few
    units to tens, per-tile CfL maps, the DCT8 table; per-block EPF sigma (one block
    below kMinSigma, so the pass-through runs) expanded per pixel, the
    encoder's SAD map and Gaborish."""
    rng = np.random.default_rng(seed)
    h, w = nby * 8, nbx * 8
    q = (rng.integers(-3, 4, (3, nby, nbx, 8, 8))
         * (rng.random((3, nby, nbx, 8, 8)) < 0.2)).astype(np.int32)
    qf = rng.integers(2, 30, (nby, nbx)).astype(np.int32)
    dc = rng.normal(0, 0.1, (3, nby, nbx)).astype(np.float32)
    t = -(-nby // 8), -(-nbx // 8)
    ytox = rng.integers(-10, 10, t).astype(np.int32)
    ytob = rng.integers(-45, -30, t).astype(np.int32)
    dm = library_tables()[0][0].astype(np.float32)
    isg = rng.uniform(-2.5, -0.3, (nby, nbx)).astype(np.float32)
    isg[0, 1] = -5.0
    ispx = np.repeat(np.repeat(isg, 8, 0), 8, 1)
    sad = _sad_mul_map(h, w, 2.0 / 3.0).astype(np.float32)
    gab = np.stack([gaborish_kernel(0.115169525, 0.061248592)] * 3).astype(
        np.float32)
    return (q, qf, dc, ytox, ytob, dm), ispx, sad, gab


def _jax(args):
    return [jnp.asarray(a) for a in args]


def _rgb_tol(xyb, rgb, tol=XLA_TOL):
    """Per value of linear RGB f32[..., 3, H, W]: `tol` on the XYB it is
    computed from, carried through xyb_to_rgb's cubes and matrix, plus
    `tol` on the RGB."""
    k = tpl._consts()
    x, y, b = xyb[..., 0, :, :], xyb[..., 1, :, :], xyb[..., 2, :, :]
    ex, ey, eb = (tol["atol"] + tol["rtol"] * np.abs(c) for c in (x, y, b))
    cb = float(k["cbrt_bias"])
    dmix = np.stack([3 * (y + x + cb) ** 2 * (ex + ey),
                     3 * (y - x + cb) ** 2 * (ex + ey),
                     3 * (b + cb) ** 2 * eb], axis=-3)
    carried = np.einsum("ij,...jhw->...ihw", np.abs(k["opsin_inv"]), dmix)
    return carried + tol["atol"] + tol["rtol"] * np.abs(rgb)


def _assert_rgb(got, ref, xyb, tol=XLA_TOL):
    err = np.abs(got - ref)
    assert (err <= _rgb_tol(xyb, ref, tol)).all(), err.max()


# ------------------------------------------------------------ plain forms

@pytest.mark.parametrize("form", ["decode_xyb", "decode_pixels"])
@pytest.mark.parametrize("inputs", ["pallas", "render"])
def test_plain_decode_matches_the_jax_form(form, inputs):
    args, igs = (_pallas_inputs(), 1024.0) if inputs == "pallas" \
        else (_render_inputs(5)[0], IGS)
    ref = np.asarray(getattr(jpl, form)(*_jax(args), jnp.float32(igs),
                                        1.0, 1.0))
    got = getattr(tpl, form)(*map(_t, args), igs, 1.0, 1.0)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    if form == "decode_pixels" and inputs == "pallas":
        _assert_rgb(got.numpy(), ref, np.asarray(jpl.decode_xyb(
            *_jax(args), jnp.float32(igs), 1.0, 1.0)))
    else:
        np.testing.assert_allclose(got.numpy(), ref, **XLA_TOL)


def test_plain_decode_takes_a_batch_and_the_qm_multipliers():
    """A leading batch dimension decodes each image as alone, with its own
    global scale; x/b_dm_mult and the CfL constants as the JAX form."""
    one = [_render_inputs(s)[0] for s in (6, 7)]
    batch = [np.stack(a) for a in zip(*one)]
    batch[5] = one[0][5]  # dm is shared
    got = tpl.decode_pixels(*map(_t, batch), np.float32([7.0, 9.0]), 0.8,
                            1.25)
    for i, (args, igs) in enumerate(zip(one, (7.0, 9.0))):
        single = tpl.decode_pixels(*map(_t, args), igs, 0.8, 1.25)
        np.testing.assert_allclose(got[i].numpy(), single.numpy(),
                                   rtol=1e-6, atol=1e-7)
        ref = np.asarray(jpl.decode_pixels(
            *_jax(args), jnp.float32(igs), 0.8, 1.25, color_factor=90.0,
            base_x=0.1, base_b=0.9))
        np.testing.assert_allclose(tpl.decode_pixels(
            *map(_t, args), igs, 0.8, 1.25, color_factor=90.0, base_x=0.1,
            base_b=0.9).numpy(), ref, **XLA_TOL)


@pytest.mark.parametrize("gab", [False, True], ids=["nogab", "gab"])
@pytest.mark.parametrize("epf_iters", [0, 1, 2, 3])
@pytest.mark.parametrize("to_rgb", [True, False], ids=["rgb", "xyb"])
def test_decode_render_matches_the_jax_form(epf_iters, gab, to_rgb):
    args, ispx, sad, gabk = _render_inputs(10 + epf_iters)
    gabk = gabk if gab else None
    ref = np.asarray(jpl.decode_render(
        *_jax(args), jnp.float32(IGS), 1.0, 1.0, gabk,
        jnp.asarray(ispx), jnp.asarray(sad), CS, epf_iters, to_rgb=to_rgb))
    got = tpl.decode_render(*map(_t, args), IGS, 1.0, 1.0, gabk,
                            _t(ispx), _t(sad), CS, epf_iters, to_rgb=to_rgb)
    np.testing.assert_allclose(got.numpy(), ref, **XLA_TOL)
    # the route's CPU twin is this form, launching nothing
    before = launch_counts()
    route = kernels.decode_render_blocks(
        *map(_t, args), IGS, 1.0, 1.0, gabk, _t(ispx), _t(sad), CS,
        epf_iters, to_rgb=to_rgb)
    assert launch_counts() == before
    assert torch.equal(route, got)


def test_block_layout_equals_the_image_layout_decode():
    """decode_xyb of blocks is decode_xyb_image (dequant_idct8's twin) of
    the image-layout copy, and blocks_to_image / image_to_blocks invert
    each other with a batch dimension too."""
    args = list(map(_t, _render_inputs(20)[0]))
    xyb = tpl.decode_xyb(*args, IGS, 1.0, 1.0)
    qimg = tpl.blocks_to_image(args[0])
    assert qimg.is_contiguous()
    ref = tpl.decode_xyb_image(qimg, *args[1:], IGS, 1.0, 1.0)
    np.testing.assert_allclose(xyb.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    q2 = torch.stack([args[0], -args[0]])
    assert torch.equal(tpl.image_to_blocks(tpl.blocks_to_image(q2)), q2)
    assert torch.equal(tpl.blocks_to_image(q2)[1], -qimg)


# --------------------------------------------------------- kernel routes

def test_decode_pixels_hybrid_matches_the_pallas_route():
    """tests/test_pallas.py's case: the port's route on CPU tensors (its
    twin) against the JAX route with K1 in interpret mode, and against
    the JAX XLA form at its tolerance."""
    args = _pallas_inputs()
    ref = np.asarray(jhybrid(*_jax(args), jnp.float32(1024.0),
                             interpret=True))
    xla = np.asarray(jpl.decode_pixels(*_jax(args), jnp.float32(1024.0),
                                       1.0, 1.0))
    before = launch_counts()
    got = kernels.decode_pixels_hybrid(*map(_t, args), 1024.0).numpy()
    assert launch_counts() == before
    np.testing.assert_allclose(got, ref, **PALLAS_TOL)
    _assert_rgb(got, xla, np.asarray(jpl.decode_xyb(
        *_jax(args), jnp.float32(1024.0), 1.0, 1.0)))
    # at a d1 stream's magnitudes the RGB itself holds the XLA bound
    args = _render_inputs(31)[0]
    got = kernels.decode_pixels_hybrid(*map(_t, args), IGS).numpy()
    np.testing.assert_allclose(got, np.asarray(jhybrid(
        *_jax(args), jnp.float32(IGS), interpret=True)), **XLA_TOL)


def test_block_routes_refuse_what_the_kernels_cannot_run():
    args, ispx, sad, gab = _render_inputs(30)
    targs = list(map(_t, args))
    with pytest.raises(ValueError, match="fixes color_factor"):
        kernels.decode_pixels_hybrid(*targs, 1024.0, color_factor=90.0)
    with pytest.raises(ValueError, match="fixes color_factor"):
        kernels.decode_pixels_hybrid(*targs, 1024.0, base_b=0.5)
    with pytest.raises(ValueError, match="qcoeffs shape"):
        kernels.decode_pixels_hybrid(tpl.blocks_to_image(targs[0]),
                                     *targs[1:], 1024.0)
    bad = ispx.copy()
    bad[3, 5] += 1.0
    tail = (IGS, 1.0, 1.0, gab, _t(bad), _t(sad), CS)
    with pytest.raises(ValueError, match="constant on each 8x8 block"):
        kernels.decode_render_blocks(*targs, *tail, 2)
    with pytest.raises(ValueError, match="epf_iters 4"):
        kernels.decode_render_blocks(*targs, *tail, 4)
    # without EPF the sigma is not read
    out = kernels.decode_render_blocks(*targs, *tail, 0)
    assert tuple(out.shape) == (3, 128, 128)


# --------------------------------------------------------------------- xyb

def test_make_torch_xyb_matches_make_jax_xyb():
    rng = np.random.default_rng(40)
    rgb = rng.uniform(-0.05, 1.05, (3, 24, 40)).astype(np.float32)
    jto, jfrom = make_jax_xyb()
    tto, tfrom = make_torch_xyb()
    xyb = tto(_t(rgb))
    ref = np.asarray(jto(jnp.asarray(rgb)))
    np.testing.assert_allclose(xyb.numpy(), ref, rtol=1e-6, atol=1e-7)
    back = tfrom(_t(np.array(ref))).numpy()
    np.testing.assert_allclose(back, np.asarray(jfrom(jnp.asarray(ref))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(back, rgb, rtol=1e-4, atol=1e-5)
    assert xyb.dtype == torch.float32 and tuple(xyb.shape) == rgb.shape


# ------------------------------------------------------------------- entry

def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_on_the_cpu_matches_the_jax_entry():
    jfn, jargs = _graft_entry().entry()
    fn, args = tentry.entry(device="cpu")
    assert len(args) == len(jargs) == 6
    for a, j in zip(args, jargs):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
        assert a.numpy().dtype == np.asarray(j).dtype
    ref = np.asarray(jax.jit(jfn)(*jargs))
    before = launch_counts()
    got = fn(*args)
    assert launch_counts() == before
    assert tuple(got.shape) == ref.shape == (3, 256, 256)
    # AC in [-15, 15] at global scale 1024: XYB in the tens
    _assert_rgb(got.numpy(), ref, np.asarray(jpl.decode_xyb(
        *jargs, jnp.float32(1024.0), 1.0, 1.0)))
    assert fn.func is kernels.decode_pixels_hybrid


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry()


def test_entry_dryrun_delegates_to_the_dry_run(monkeypatch):
    from libjxl_tpu_torch.parallel import dryrun

    seen = []
    monkeypatch.setattr(dryrun, "dryrun_multichip",
                        lambda n, device, big_mp: seen.append(
                            (n, device, big_mp)) or {"ok": n})
    assert tentry.dryrun_multichip(4, device="cpu", big_mp=0.5) == {"ok": 4}
    assert tentry.dryrun_multichip(2) == {"ok": 2}
    assert seen == [(4, "cpu", 0.5), (2, "cuda", 64.0)]
