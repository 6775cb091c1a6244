"""libjxl_tpu_torch/ops/kernels.py: the kernels' plain twins against the
JAX package's Pallas kernels (interpret mode) and XLA forms, and the CPU
dispatch of the wrappers (the kernels themselves: test_torch_cuda.py)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from libjxl_tpu.ops import pallas_kernels as jpk
from libjxl_tpu.ops import pipeline as jpl
from libjxl_tpu_torch.base.device import launch_counts
from libjxl_tpu_torch.ops import build, kernels
from libjxl_tpu_torch.ops import pipeline as tpl
from test_torch_cuda import (CS, GEOMETRIES, _dequant_inputs, _epf_inputs,
                             _t)



def test_dequant_cfl_matches_pallas_interpret():
    # scale (inv_global_scale / qf) and dm at real d1 streams' magnitudes:
    # the bound is on coefficients of that size
    rng = np.random.default_rng(11)
    h, w = 64, 128
    q = rng.integers(-15, 15, (3, h, w)).astype(np.int32)
    scale = rng.uniform(0.3, 10.0, (h, w)).astype(np.float32)
    dm = rng.uniform(3e-4, 0.07, (3, h, w)).astype(np.float32)
    xcc = rng.uniform(-0.2, 0.2, (h, w)).astype(np.float32)
    bcc = rng.uniform(0.5, 1.5, (h, w)).astype(np.float32)
    ref = np.asarray(jpk.dequant_cfl_pallas(
        jnp.asarray(q), jnp.asarray(scale), jnp.asarray(dm),
        jnp.asarray(xcc), jnp.asarray(bcc), interpret=True))
    got = kernels.dequant_cfl(_t(q), _t(scale), _t(dm), _t(xcc), _t(bcc))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_epf_pass_matches_pallas_interpret(geometry):
    neigh, pattern, scale = GEOMETRIES[geometry]
    xyb, isg, sad = _epf_inputs(12, 1, 64, 128)
    isp = np.repeat(np.repeat(isg[0], 8, 0), 8, 1)
    ref = np.asarray(jpk.epf_pass_pallas(
        jnp.asarray(xyb[0]), jnp.asarray(isp), jnp.asarray(sad), CS, neigh,
        pattern, scale, rows_per_program=32, interpret=True))
    got = tpl._epf_pass(_t(xyb[0]), _t(isp), _t(sad), CS, neigh, pattern,
                        scale)
    # the Pallas form sums SAD tap by tap, the XLA form by shared planes
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_epf_pass_matches_xla(geometry):
    neigh, pattern, scale = GEOMETRIES[geometry]
    xyb, isg, sad = _epf_inputs(13, 2, 40, 56)
    isp = np.repeat(np.repeat(isg, 8, 1), 8, 2)
    got = tpl._epf_pass(_t(xyb), _t(isp), _t(sad), CS, neigh, pattern,
                        scale)
    for i in range(2):
        ref = np.asarray(jpl._epf_pass_jax(
            jnp.asarray(xyb[i]), jnp.asarray(isp[i]), jnp.asarray(sad), CS,
            neigh, pattern, np.float32(scale)))
        np.testing.assert_allclose(got[i].numpy(), ref, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_epf_pass_wrapper_on_cpu_is_the_plain_twin(geometry):
    """On a CPU tensor the wrapper expands the per-block sigma and returns
    _epf_pass exactly, and launches (counts) nothing."""
    neigh, pattern, scale = GEOMETRIES[geometry]
    xyb, isg, sad = _epf_inputs(14, 2, 37, 50)  # ragged: not 8-multiples
    before = launch_counts()
    got = kernels.epf_pass(_t(xyb), _t(isg), _t(sad), CS, neigh, pattern,
                           scale)
    isp = np.repeat(np.repeat(isg, 8, 1), 8, 2)[:, :37, :50]
    ref = tpl._epf_pass(_t(xyb), _t(isp), _t(sad), CS, neigh, pattern,
                        scale)
    assert torch.equal(got, ref)
    assert launch_counts() == before


def test_dequant_idct8_wrapper_on_cpu_is_the_plain_twin():
    args = [_t(a) for a in _dequant_inputs(15, 2, 64, 80, np.int16)]
    before = launch_counts()
    got = kernels.dequant_idct8(*args, 0.8, 1.0)
    assert torch.equal(got, tpl.decode_xyb_image(*args, 0.8, 1.0))
    assert got.shape == (2, 3, 64, 80) and got.dtype == torch.float32
    assert launch_counts() == before


def test_wrappers_refuse_other_devices_and_geometries():
    """No silent fallback: a tensor on neither the CPU nor CUDA raises,
    and so does an EPF geometry the kernel does not implement."""
    xyb = torch.empty((1, 3, 16, 16), device="meta")
    isg = torch.empty((1, 2, 2), device="meta")
    sad = torch.empty((16, 16), device="meta")
    with pytest.raises(ValueError):
        kernels.epf_pass(xyb, isg, sad, CS, tpl._EPF12_NEIGHBORS, None, 1.0)
    q = torch.empty((1, 3, 16, 16), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError):
        kernels.dequant_idct8(q, None, None, None, None, None, 1.0, 1.0,
                              1.0)
    with pytest.raises(ValueError):
        kernels.epf_pass(torch.zeros((3, 16, 16)), torch.zeros((2, 2)),
                         torch.ones((16, 16)), CS, tpl._EPF0_NEIGHBORS, None,
                         1.0)


def test_build_is_keyed_by_sources_and_needs_nvcc(monkeypatch, tmp_path):
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path == build.library_path()  # deterministic
    assert path.name.startswith("libjxl_kernels_") and path.suffix == ".so"
    if path.exists():
        pytest.skip("kernels already built here")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
