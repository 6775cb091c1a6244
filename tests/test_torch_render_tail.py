"""libjxl_tpu_torch/ops render tail (Gaborish -> EPF chain -> XYB or sRGB
u8): the plain twin render_tail_plain against the JAX package's forms
(libjxl_tpu/ops/pipeline.py gaborish_jax -> epf_jax(use_pallas=False) ->
the u8srgb write of decode_render_image), the CPU dispatch of
kernels.render_tail, and the plain tiled form render_tail_tiled, which
runs the kernel's tiles, halos and per-stage edge refills, against the
untiled chain. The kernel itself: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from libjxl_tpu.ops import pipeline as jpl
from libjxl_tpu_torch.base.device import launch_counts
from libjxl_tpu_torch.ops import build, kernels
from libjxl_tpu_torch.ops import pipeline as tpl
from libjxl_tpu_torch.probes import tail_variants
from test_torch_cuda import _t, _tail_inputs, chain_tol

CS = (40.0, 5.0, 3.5)
SIZES = [(8, 8), (16, 8), (70, 50)]
GAB = [False, True]
EPF_ITERS = [0, 1, 2, 3]


def _jax_tail(xyb, isg, gab, sad, epf_iters, u8):
    """The reference chain on one image: numpy out."""
    h, w = xyb.shape[-2:]
    x = jnp.asarray(xyb)
    if gab is not None:
        x = jpl.gaborish_jax(x, jnp.asarray(gab))
    if epf_iters:
        isp = np.repeat(np.repeat(isg, 8, 0), 8, 1)[:h, :w]
        x = jpl.epf_jax(x, jnp.asarray(isp), jnp.asarray(sad), CS, epf_iters,
                        np.float32(0.9), np.float32(6.5), use_pallas=False)
    if not u8:
        return np.asarray(x)
    # decode_render_image's u8srgb write
    rgb = jpl.xyb_to_rgb_jax(x)
    low = rgb <= 0.0031308
    srgb = jnp.where(low, rgb * 12.92,
                     1.055 * jnp.maximum(rgb, 1e-12) ** (1 / 2.4) - 0.055)
    u8 = jnp.clip(jnp.round(srgb * 255.0), 0, 255).astype(jnp.uint8)
    return np.asarray(u8.transpose(1, 2, 0))


def _case_id(v):
    if isinstance(v, tuple):
        return f"{v[0]}x{v[1]}"
    if isinstance(v, bool):
        return "gab" if v else "nogab"
    return f"epf{v}"


@pytest.mark.parametrize("size", SIZES, ids=_case_id)
@pytest.mark.parametrize("gab", GAB, ids=_case_id)
@pytest.mark.parametrize("epf_iters", EPF_ITERS, ids=_case_id)
def test_render_tail_plain_matches_jax(size, gab, epf_iters):
    h, w = size
    xyb, isg, gabk, sad = _tail_inputs(40 + h + w + epf_iters, 2, h, w)
    gk = gabk if gab else None
    args = (_t(xyb), None if gk is None else _t(gk), _t(isg), _t(sad), CS,
            epf_iters, 0.9, 6.5)
    got = tpl.render_tail_plain(*args, out="xyb")
    got_u8 = tpl.render_tail_plain(*args, out="u8srgb")
    assert got.shape == (2, 3, h, w) and got_u8.shape == (2, h, w, 3)
    assert got_u8.dtype == torch.uint8
    for i in range(2):
        ref = _jax_tail(xyb[i], isg[i], gk, sad, epf_iters, u8=False)
        np.testing.assert_allclose(got[i].numpy(), ref,
                                   **chain_tol(gab, epf_iters))
        ref_u8 = _jax_tail(xyb[i], isg[i], gk, sad, epf_iters, u8=True)
        assert np.abs(got_u8[i].numpy().astype(int)
                      - ref_u8.astype(int)).max() <= 1


@pytest.mark.parametrize("out", ["xyb", "u8srgb"])
@pytest.mark.parametrize("epf_iters", EPF_ITERS, ids=_case_id)
def test_render_tail_wrapper_on_cpu_is_the_plain_twin(epf_iters, out):
    """On a CPU tensor kernels.render_tail returns render_tail_plain
    exactly, and launches (counts) nothing."""
    xyb, isg, gabk, sad = _tail_inputs(60 + epf_iters, 2, 37, 50)
    args = (_t(xyb), _t(gabk), _t(isg), _t(sad), CS, epf_iters, 0.9, 6.5)
    before = launch_counts()
    got = kernels.render_tail(*args, out=out)
    assert torch.equal(got, tpl.render_tail_plain(*args, out=out))
    assert launch_counts() == before


@pytest.mark.parametrize("tile", [build.RENDER_TILE, (8, 16)],
                         ids=lambda t: f"tile{t[0]}x{t[1]}")
@pytest.mark.parametrize("size", SIZES, ids=_case_id)
@pytest.mark.parametrize("gab", GAB, ids=_case_id)
@pytest.mark.parametrize("epf_iters", EPF_ITERS, ids=_case_id)
def test_render_tail_tiled_equals_untiled(size, gab, epf_iters, tile):
    """The kernel's tiling, halo and per-stage mirror refill, in plain
    torch, give the untiled chain's XYB exactly: at the wrapper's tile
    (one or a few ragged tiles at these sizes) and at a small tile that
    puts interior tiles, edge tiles and tiles narrower than the halo in
    one image."""
    h, w = size
    xyb, isg, gabk, sad = _tail_inputs(80 + h + w + epf_iters, 2, h, w)
    args = (_t(xyb), _t(gabk) if gab else None, _t(isg), _t(sad), CS,
            epf_iters, 0.9, 6.5)
    got = tpl.render_tail_tiled(*args, tile=tile)
    assert torch.equal(got, tpl.render_tail_plain(*args))


def test_render_tail_tiled_needs_the_halo():
    xyb, isg, gabk, sad = _tail_inputs(90, 1, 6, 16)
    with pytest.raises(ValueError, match="below the halo"):
        tpl.render_tail_tiled(_t(xyb), _t(gabk), _t(isg), _t(sad), CS, 3,
                              tile=build.RENDER_TILE)


def test_halo_is_the_sum_of_stage_radii():
    """The radii the kernel's halo adds up (render_tail.cu Chain): Gaborish
    1; EPF pass 0 3, pass 1 2, pass 2 1 (neighbour plus SAD tap)."""
    assert tpl.GABORISH_RADIUS == 1
    assert [tpl.epf_radius(p) for p in range(3)] == [3, 2, 1]
    halo = {n: tpl.GABORISH_RADIUS + sum(map(tpl.epf_radius, passes))
            for n, passes in tpl.EPF_CHAINS.items()}
    assert halo == {0: 1, 1: 3, 2: 4, 3: 7}


def test_render_tail_wrapper_refuses_other_devices_and_options():
    xyb = torch.empty((1, 3, 16, 16), device="meta")
    isg = torch.empty((1, 2, 2), device="meta")
    sad = torch.empty((16, 16), device="meta")
    with pytest.raises(ValueError):
        kernels.render_tail(xyb, None, isg, sad, CS, 2)
    with pytest.raises(ValueError):
        kernels.render_tail(torch.zeros((3, 16, 16)), None,
                            torch.zeros((2, 2)), torch.ones((16, 16)), CS, 2,
                            out="rgb")
    with pytest.raises(ValueError):
        kernels.render_tail(torch.zeros((3, 16, 16)), None,
                            torch.zeros((2, 2)), torch.ones((16, 16)), CS, 4)


def test_mirror_to_true_size_matches_jax_branch():
    """The true-size mirror, factored out of decode_render_image, is the
    JAX branch's (libjxl_tpu/ops/pipeline.py:436-447)."""
    rng = np.random.default_rng(91)
    xyb = rng.normal(0, 0.3, (3, 24, 40)).astype(np.float32)
    got = tpl.mirror_to_true_size(_t(xyb.copy()), (19, 35)).numpy()
    ref = xyb.copy()
    ref[:, 19:24] = ref[:, 14:19][:, ::-1]
    ref[:, :, 35:40] = ref[:, :, 30:35][:, :, ::-1]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", sorted(tail_variants.VARIANTS))
def test_tail_variants_apply_to_the_source(name):
    """Each design variant that PERF.md reports is the committed
    render_tail.cu with its substitutions, every one of which still
    matches the source (the probe raises otherwise)."""
    src = tail_variants.SOURCE.read_text()
    text = tail_variants.variant_source(name)
    subs = tail_variants.VARIANTS[name][1]
    assert (text == src) == (not subs)
    for old, new in subs:
        assert old in src and (new in text or not new)
