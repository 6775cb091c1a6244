"""libjxl_tpu_torch/ops/pipeline.py and base/device.py: the plain torch
decode stages against the JAX package's forms (libjxl_tpu/ops/pipeline.py)
on the same numpy inputs, on the CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from libjxl_tpu.ops import pipeline as jpl
from libjxl_tpu.render.pipeline import _sad_mul_map, gaborish_kernel
from libjxl_tpu_torch.base import device as tdev
from libjxl_tpu_torch.ops import pipeline as tpl

TOL = dict(rtol=1e-5, atol=1e-5)
CS = (40.0, 5.0, 3.5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _image_inputs(seed, b, h, w):
    """A staged batch at the magnitudes real d1 streams give, with the
    filter tables the encoder signals by default."""
    rng = np.random.default_rng(seed)
    nby, nbx = h // 8, w // 8
    nty, ntx = -(-nby // 8), -(-nbx // 8)
    gab = np.stack([gaborish_kernel(0.115169525, 0.061248592)] * 3)
    # sparse AC and in-gamut DC, as a photo gives: the cubes of
    # XYB->RGB amplify float noise on out-of-gamut values
    sparse = rng.random((b, 3, h, w)) < 0.1
    dc = np.stack([rng.normal(0, 0.01, (b, nby, nbx)),
                   rng.uniform(0.1, 0.7, (b, nby, nbx)),
                   rng.uniform(0.1, 0.7, (b, nby, nbx))], axis=1)
    return dict(
        qimg=(rng.integers(-3, 4, (b, 3, h, w)) * sparse).astype(np.int16),
        qf=rng.integers(2, 30, (b, nby, nbx)).astype(np.int32),
        dc=dc.astype(np.float32),
        ytox=rng.integers(-10, 10, (b, nty, ntx)).astype(np.int32),
        ytob=rng.integers(-45, -30, (b, nty, ntx)).astype(np.int32),
        dm=rng.uniform(3e-4, 0.01, (3, 8, 8)).astype(np.float32),
        igs=rng.uniform(6.0, 10.0, (b,)).astype(np.float32),
        isg=rng.uniform(-2.5, -1.0, (b, nby, nbx)).astype(np.float32),
        gab=gab.astype(np.float32),
        sad=_sad_mul_map(h, w, 2.0 / 3.0).astype(np.float32))


def test_pad_symmetric_matches_numpy():
    x = np.arange(2 * 5 * 7, dtype=np.float32).reshape(2, 5, 7)
    for pad in (1, 3, 4, 6):
        ref = np.pad(x, ((0, 0), (pad, pad), (pad, pad)), mode="symmetric")
        assert np.array_equal(tpl._pad_symmetric(_t(x), pad).numpy(), ref)


def test_adjust_quant_bias_matches_jax():
    q = np.arange(-40, 41, dtype=np.int32).reshape(1, 81)
    for c in range(3):
        ref = np.asarray(jpl.adjust_quant_bias_jax(jnp.asarray(q), c))
        np.testing.assert_array_equal(
            tpl.adjust_quant_bias(_t(q), c).numpy(), ref)


def test_idct8_image_and_xyb_to_rgb_match_jax():
    rng = np.random.default_rng(21)
    coeffs = rng.normal(0, 0.3, (3, 32, 48)).astype(np.float32)
    np.testing.assert_allclose(
        tpl.idct8_image(_t(coeffs)).numpy(),
        np.asarray(jpl.idct8_image(jnp.asarray(coeffs))), **TOL)
    xyb = np.stack([rng.normal(0, 0.02, (24, 40)),
                    rng.uniform(0.1, 0.8, (24, 40)),
                    rng.uniform(0.1, 0.8, (24, 40))]).astype(np.float32)
    np.testing.assert_allclose(
        tpl.xyb_to_rgb(_t(xyb)).numpy(),
        np.asarray(jpl.xyb_to_rgb_jax(jnp.asarray(xyb))), **TOL)


def test_decode_xyb_image_matches_jax_per_image():
    d = _image_inputs(22, 2, 64, 136)
    got = tpl.decode_xyb_image(_t(d["qimg"]), _t(d["qf"]), _t(d["dc"]),
                               _t(d["ytox"]), _t(d["ytob"]), _t(d["dm"]),
                               _t(d["igs"]), 0.8, 1.0)
    assert got.shape == (2, 3, 64, 136)
    for i in range(2):
        ref = jpl.decode_xyb_image(
            jnp.asarray(d["qimg"][i].astype(np.int32)),
            jnp.asarray(d["qf"][i]), jnp.asarray(d["dc"][i]),
            jnp.asarray(d["ytox"][i]), jnp.asarray(d["ytob"][i]),
            jnp.asarray(d["dm"]), d["igs"][i], np.float32(0.8),
            np.float32(1.0))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), **TOL)


def test_gaborish_matches_jax():
    rng = np.random.default_rng(23)
    xyb = rng.normal(0, 0.3, (2, 3, 24, 40)).astype(np.float32)
    k = np.stack([gaborish_kernel(0.1, 0.05), gaborish_kernel(0.12, 0.06),
                  gaborish_kernel(0.09, 0.04)]).astype(np.float32)
    got = tpl.gaborish(_t(xyb), _t(k))
    for i in range(2):
        ref = jpl.gaborish_jax(jnp.asarray(xyb[i]), jnp.asarray(k))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("epf_iters,to_rgb,true_size", [
    (0, False, None),
    (1, True, None),
    (2, "u8srgb", None),
    (3, False, None),
    (2, False, (61, 130)),
    (2, "u8srgb", (61, 130)),
])
def test_decode_render_image_matches_jax(epf_iters, to_rgb, true_size):
    d = _image_inputs(24 + epf_iters, 2, 64, 136)
    got = tpl.decode_render_image(
        _t(d["qimg"]), _t(d["qf"]), _t(d["dc"]), _t(d["ytox"]),
        _t(d["ytob"]), _t(d["dm"]), _t(d["igs"]), 0.8, 1.0, _t(d["gab"]),
        _t(d["isg"]), _t(d["sad"]), CS, epf_iters, to_rgb=to_rgb,
        pass0_sigma_scale=0.9, pass2_sigma_scale=6.5, true_size=true_size)
    for i in range(2):
        isp = np.repeat(np.repeat(d["isg"][i], 8, 0), 8, 1)
        ref = np.asarray(jpl.decode_render_image(
            jnp.asarray(d["qimg"][i].astype(np.int32)),
            jnp.asarray(d["qf"][i]), jnp.asarray(d["dc"][i]),
            jnp.asarray(d["ytox"][i]), jnp.asarray(d["ytob"][i]),
            jnp.asarray(d["dm"]), d["igs"][i], np.float32(0.8),
            np.float32(1.0), jnp.asarray(d["gab"]), jnp.asarray(isp),
            jnp.asarray(d["sad"]), CS, epf_iters, to_rgb=to_rgb,
            pass0_sigma_scale=np.float32(0.9),
            pass2_sigma_scale=np.float32(6.5), true_size=true_size,
            use_pallas=False))
        out = got[i].numpy()
        assert out.shape == ref.shape and out.dtype == ref.dtype
        if to_rgb == "u8srgb":
            assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(out, ref, **TOL)


def test_resolve_device_and_precision_policy(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert tdev.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError):
        tdev.resolve_device("meta")
    if not torch.cuda.is_available():
        # no silent CPU fallback
        with pytest.raises(RuntimeError):
            tdev.resolve_device("cuda")


def test_launch_counters_register_count_and_reset():
    c = tdev.launch_counter("test_counter")
    assert tdev.launch_counter("test_counter") is c
    c.add()
    c.add()
    assert tdev.launch_counts()["test_counter"] == 2
    tdev.reset_launch_counts()
    assert tdev.launch_counts()["test_counter"] == 0
