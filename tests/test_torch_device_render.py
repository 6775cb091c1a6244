"""The stages of libjxl_tpu_torch's single-image device render
(ops/pipeline.py's strategy stages and YCbCr render, ops/dct.py's torch
transforms) against the JAX package's on the same seeded inputs, on the
CPU. Whole decodes: tests/test_torch_device_decode.py.

The JAX side runs its XLA forms (JAX_PLATFORMS=cpu; no Pallas kernel is
on these paths there). Floats are held to atol 2e-5 / rtol 1e-5 (values
of order 1; sums of up to 64 products in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libjxl_tpu.ops import pipeline as jpl
from libjxl_tpu.ops.dct import make_jax_dct
from libjxl_tpu_torch.ops import pipeline as tpl
from libjxl_tpu_torch.ops.dct import (resample_scales, torch_dct2d,
                                      torch_idct2d)
from libjxl_tpu_torch.render.pipeline import _sad_mul_map, gaborish_kernel
from libjxl_tpu_torch.vardct import ac_strategy as acs

TOL = dict(rtol=1e-5, atol=2e-5)
CS = (40.0, 5.0, 3.5)
SPECIAL = [s for s in range(acs.NUM_STRATEGIES)
           if acs.COVERED_X[s] == acs.COVERED_Y[s] == 1]
# the plain DCT sizes a dense size pass takes (max side <= 64)
PLAIN = [(acs.COVERED_Y[s] * 8, acs.COVERED_X[s] * 8) for s in (
    acs.DCT16X16, acs.DCT32X32, acs.DCT16X8, acs.DCT8X16, acs.DCT32X8,
    acs.DCT8X32, acs.DCT32X16, acs.DCT16X32, acs.DCT64X64, acs.DCT64X32,
    acs.DCT32X64)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _cfl_inputs(rng, n):
    """Per-tile scale and CfL factors at real streams' magnitudes."""
    return (rng.uniform(0.2, 2.0, n).astype(np.float32),
            rng.uniform(-0.1, 0.1, n).astype(np.float32),
            rng.uniform(0.6, 1.2, n).astype(np.float32))


def _coeffs(rng, shape):
    """Sparse small quantized coefficients, as a photo's AC gives."""
    return (rng.integers(-4, 5, shape)
            * (rng.random(shape) < 0.3)).astype(np.int32)


@pytest.mark.parametrize("rows,cols", [(8, 8), (16, 8), (8, 16), (32, 32),
                                       (64, 32), (16, 256)])
def test_torch_dct_matches_make_jax_dct(rows, cols):
    rng = np.random.default_rng(rows * 1000 + cols)
    jdct2d, jidct2d = make_jax_dct()
    px = rng.normal(0, 1, (2, 3, rows, cols)).astype(np.float32)
    _close(torch_dct2d(_t(px), rows, cols), jdct2d(jnp.asarray(px), rows,
                                                    cols))
    # coefficients whose pixels are of order 1
    wide = rng.normal(0, (rows * cols) ** -0.5,
                      (2, 3, min(rows, cols), max(rows, cols))) \
        .astype(np.float32)
    _close(torch_idct2d(_t(wide), rows, cols),
           jidct2d(jnp.asarray(wide), rows, cols))


@pytest.mark.parametrize("strategy", SPECIAL,
                         ids=[acs.STRATEGY_NAMES[s] for s in SPECIAL])
def test_decode_special_tiles_matches_jax(strategy):
    rng = np.random.default_rng(strategy)
    n = 8
    q = _coeffs(rng, (n, 3, 64))
    dc = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    scaled, x_cc, b_cc = _cfl_inputs(rng, n)
    dm = rng.uniform(3e-4, 0.05, (3, 64)).astype(np.float32)
    mat = tpl.special_matrix(strategy)
    np.testing.assert_array_equal(mat, jpl.special_matrix(strategy))
    got = tpl.decode_special_tiles(_t(q), _t(dc), _t(scaled), _t(x_cc),
                                   _t(b_cc), _t(dm), _t(mat), 0.8, 1.25)
    ref = jpl.decode_special_tiles(
        jnp.asarray(q), jnp.asarray(dc), jnp.asarray(scaled),
        jnp.asarray(x_cc), jnp.asarray(b_cc), jnp.asarray(dm),
        jnp.asarray(mat), np.float32(0.8), np.float32(1.25))
    assert got.shape == (n, 3, 8, 8)
    _close(got, ref)


def _big_inputs(rng, n, rows, cols):
    cy, cx = rows // 8, cols // 8
    wr, wc = min(rows, cols), max(rows, cols)
    lh, lw = min(cy, cx), max(cy, cx)
    scaled, x_cc, b_cc = _cfl_inputs(rng, n)
    return dict(q=_coeffs(rng, (n, 3, wr, wc)),
                dc=rng.normal(0, 0.5, (n, 3, cy, cx)).astype(np.float32),
                scaled=scaled, x_cc=x_cc, b_cc=b_cc,
                dm=rng.uniform(3e-4, 0.05, (3, wr, wc)).astype(np.float32),
                llf_sy=resample_scales(lh, lh * 8).astype(np.float32),
                llf_sx=resample_scales(lw, lw * 8).astype(np.float32))


@pytest.mark.parametrize("rows,cols", [(64, 128), (16, 8)],
                         ids=["above-64px", "unaligned-route"])
def test_decode_big_tiles_matches_jax(rows, cols):
    """A tile above 64 px, and a size that reaches the batched tiles when
    the padded grid does not divide by it."""
    rng = np.random.default_rng(rows + cols)
    b = _big_inputs(rng, 4, rows, cols)
    keys = ("q", "dc", "scaled", "x_cc", "b_cc", "dm")
    got = tpl.decode_big_tiles(*(_t(b[k]) for k in keys), 0.8, 1.25, rows,
                               cols, _t(b["llf_sy"]), _t(b["llf_sx"]))
    ref = jpl.decode_big_tiles(*(jnp.asarray(b[k]) for k in keys),
                               np.float32(0.8), np.float32(1.25), rows, cols,
                               jnp.asarray(b["llf_sy"]),
                               jnp.asarray(b["llf_sx"]))
    assert got.shape == (4, 3, rows, cols)
    _close(got, ref)


def _size_pass_inputs(rng, h, w, rows, cols):
    cy, cx = rows // 8, cols // 8
    wr, wc = min(rows, cols), max(rows, cols)
    lh, lw = min(cy, cx), max(cy, cx)
    nby, nbx = h // 8, w // 8
    mask = np.zeros((wr, wc), dtype=bool)
    mask[:lh, :lw] = True
    # per-pixel maps constant within a tile, as the caller builds them
    blocks = rng.uniform(0.2, 2.0, (nby, nbx)).astype(np.float32)
    tiles = rng.uniform(-0.1, 0.1, (-(-nby // 8), -(-nbx // 8)))
    return dict(
        qimg=_coeffs(rng, (3, h, w)),
        qf_px=np.repeat(np.repeat(blocks, 8, 0), 8, 1),
        dc=rng.normal(0, 0.5, (3, nby, nbx)).astype(np.float32),
        ytox_px=np.repeat(np.repeat(tiles, 64, 0), 64, 1)[:h, :w]
        .astype(np.float32),
        ytob_px=(1.0 + np.repeat(np.repeat(tiles, 64, 0), 64, 1)[:h, :w])
        .astype(np.float32),
        dm_tile=rng.uniform(3e-4, 0.05, (3, rows, cols)).astype(np.float32),
        llf_sy=resample_scales(lh, lh * 8).astype(np.float32),
        llf_sx=resample_scales(lw, lw * 8).astype(np.float32),
        llf_mask=mask.reshape(rows, cols))


@pytest.mark.parametrize("rows,cols", PLAIN,
                         ids=[f"{r}x{c}" for r, c in PLAIN])
def test_decode_size_pass_matches_jax(rows, cols):
    rng = np.random.default_rng(rows * 7 + cols)
    d = _size_pass_inputs(rng, 128, 192, rows, cols)
    head = ("qimg", "qf_px", "dc", "ytox_px", "ytob_px", "dm_tile")
    tail = ("llf_sy", "llf_sx", "llf_mask")
    got = tpl.decode_size_pass(*(_t(d[k]) for k in head), 0.8, 1.25, rows,
                               cols, *(_t(d[k]) for k in tail))
    ref = jpl.decode_size_pass(*(jnp.asarray(d[k]) for k in head),
                               np.float32(0.8), np.float32(1.25), rows, cols,
                               *(jnp.asarray(d[k]) for k in tail))
    assert got.shape == (3, 128, 192)
    _close(got, ref)


def test_scatter_tiles_matches_jax():
    """Distinct tiles plus the batch's zero padding tiles at (0, 0)."""
    rng = np.random.default_rng(5)
    rows, cols, h, w = 16, 32, 64, 128
    acc = rng.normal(0, 1, (3, h // rows, rows, w // cols, cols)) \
        .astype(np.float32)
    ys = np.array([0, 1, 3, 2, 0, 0, 0, 0], dtype=np.int32)
    xs = np.array([0, 3, 1, 2, 0, 0, 0, 0], dtype=np.int32)
    pix = rng.normal(0, 1, (8, 3, rows, cols)).astype(np.float32)
    pix[4:] = 0.0
    got = tpl.scatter_tiles(_t(acc.copy()), _t(pix), _t(ys), _t(xs))
    ref = jpl.scatter_tiles(jnp.asarray(acc), jnp.asarray(pix),
                            jnp.asarray(ys), jnp.asarray(xs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_decode_render_image_strategy_branch_matches_jax():
    """Every class of the branch at once: DCT8 blocks, two size passes,
    an 8x8 special batch and a 64x128 big-tile batch (scattered), the
    true-size mirror, Gaborish and 2 EPF passes, XYB out."""
    rng = np.random.default_rng(9)
    h, w = 128, 256
    nby, nbx = h // 8, w // 8
    qimg = _coeffs(rng, (3, h, w))
    qf = rng.integers(2, 30, (nby, nbx)).astype(np.int32)
    dc = np.stack([rng.normal(0, 0.01, (nby, nbx)),
                   rng.uniform(0.1, 0.7, (nby, nbx)),
                   rng.uniform(0.1, 0.7, (nby, nbx))]).astype(np.float32)
    ytox = rng.integers(-10, 10, (2, 4)).astype(np.int32)
    ytob = rng.integers(-45, -30, (2, 4)).astype(np.int32)
    dm = rng.uniform(3e-4, 0.01, (3, 8, 8)).astype(np.float32)
    class_map = rng.integers(-1, 3, (nby, nbx)).astype(np.int32)
    passes, shapes = [], ((16, 16), (32, 16))
    for rows, cols in shapes:
        d = _size_pass_inputs(rng, h, w, rows, cols)
        passes.append({k: d[k] for k in ("dm_tile", "llf_sy", "llf_sx",
                                         "llf_mask")})
    special = dict(q=_coeffs(rng, (4, 3, 64)),
                   dc=rng.normal(0, 0.3, (4, 3)).astype(np.float32),
                   mat=tpl.special_matrix(acs.AFV2),
                   dm=rng.uniform(3e-4, 0.05, (3, 64)).astype(np.float32),
                   ys=np.array([1, 5, 9, 0], np.int32),
                   xs=np.array([2, 30, 17, 0], np.int32))
    special["scaled"], special["x_cc"], special["b_cc"] = _cfl_inputs(rng, 4)
    special["q"][3] = 0
    special["dc"][3] = 0.0
    special["scaled"][3] = 0.0
    big = _big_inputs(rng, 2, 64, 128)
    big.update(ys=np.array([1, 0], np.int32), xs=np.array([1, 0], np.int32))
    extra, tile_shapes = [special, big], ((8, 8), (64, 128))
    gab = np.stack([gaborish_kernel(0.115169525, 0.061248592)] * 3) \
        .astype(np.float32)
    isg = rng.uniform(-2.5, -1.0, (nby, nbx)).astype(np.float32)
    sad = _sad_mul_map(h, w, 2.0 / 3.0).astype(np.float32)
    true_size = (h - 5, w - 3)
    got = tpl.decode_render_image(
        _t(qimg), _t(qf), _t(dc), _t(ytox), _t(ytob), _t(dm), 7.5, 0.8, 1.0,
        _t(gab), _t(isg), _t(sad), CS, 2, to_rgb=False,
        extra_tiles=[{k: _t(v) for k, v in b.items()} for b in extra],
        tile_shapes=tile_shapes,
        size_passes=[{k: _t(v) for k, v in p.items()} for p in passes],
        size_shapes=shapes, class_map=_t(class_map), true_size=true_size)
    ref = jpl.decode_render_image(
        jnp.asarray(qimg), jnp.asarray(qf), jnp.asarray(dc),
        jnp.asarray(ytox), jnp.asarray(ytob), jnp.asarray(dm),
        np.float32(7.5), np.float32(0.8), np.float32(1.0), jnp.asarray(gab),
        jnp.asarray(np.repeat(np.repeat(isg, 8, 0), 8, 1)),
        jnp.asarray(sad), CS, 2, to_rgb=False,
        pass0_sigma_scale=np.float32(0.9), pass2_sigma_scale=np.float32(6.5),
        extra_tiles=[{k: jnp.asarray(v) for k, v in b.items()}
                     for b in extra],
        dct8_mask=None, tile_shapes=tile_shapes,
        size_passes=[{k: jnp.asarray(v) for k, v in p.items()}
                     for p in passes],
        size_shapes=shapes, class_map=jnp.asarray(class_map),
        true_size=true_size, use_pallas=False)
    assert got.shape == (3, h, w)
    # Gaborish and two EPF passes compound the stages' float drift
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=6e-5)


def _subsampled_inputs(rng, nby, nbx, shifts):
    qs, dcs, scaled = [], [], []
    for c in range(3):
        hs, vs = shifts[c]
        ny, nx = -(-nby // (1 << vs)), -(-nbx // (1 << hs))
        qs.append(_coeffs(rng, (ny * 8, nx * 8)))
        dcs.append(rng.normal(0, 0.2, (ny, nx)).astype(np.float32))
        scaled.append(rng.uniform(0.02, 0.2, (ny, nx)).astype(np.float32))
    return qs, dcs, scaled


def _linear_up(plane, axis, n, extent, shift):
    """libjxl's chroma upsampling (stage_chroma_upsampling.cc) along one
    axis, NumPy: the first n outputs, output 2x = 0.75 in[x] + 0.25
    in[x - 1], 2x + 1 = 0.75 in[x] + 0.25 in[x + 1], indices clamped to
    the channel's extent, outputs past twice the extent its last."""
    if not shift:
        return np.take(plane, np.arange(n), axis)
    o = np.minimum(np.arange(n), 2 * extent - 1)
    x = o >> 1
    nb = np.clip(x - 1 + 2 * (o & 1), 0, extent - 1)
    return (np.float32(0.75) * np.take(plane, x, axis)
            + np.float32(0.25) * np.take(plane, nb, axis))


def _jax_subsampled(qs, dcs, scaled, dm, gab, isg_px, sad, shifts, h, w,
                    epf, filters, true_size):
    """jpl.decode_render_subsampled's stages (the JAX package's dequant,
    IDCT8, Gaborish, EPF and BT.601) with libjxl's linear chroma
    upsampling in place of its repetition, and the frame mirrored past
    the true size before the filters, as the host render does."""
    from libjxl_tpu.render.pipeline import mirror_fill_padding

    th, tw = true_size or (h, w)
    planes = []
    for c in range(3):
        blocks = jpl.image_to_blocks(jnp.asarray(qs[c], jnp.float32)[None])[0]
        co = jpl.adjust_quant_bias_jax(blocks, c) \
            * jnp.asarray(dm[c]).reshape(1, 1, 8, 8) \
            * jnp.asarray(scaled[c])[:, :, None, None]
        co = co.at[:, :, 0, 0].set(jnp.asarray(dcs[c]))
        plane = np.asarray(jpl.blocks_to_image(jpl.idct8_blocks(co[None]))[0])
        hs, vs = shifts[c]
        plane = _linear_up(plane, 1, w, -(-tw >> hs), hs)
        planes.append(_linear_up(plane, 0, h, -(-th >> vs), vs))
    ycc = np.stack(planes)
    if true_size is not None and filters:
        ycc = mirror_fill_padding(ycc, th, tw)
    ycc = jnp.asarray(ycc, jnp.float32)
    if filters:
        ycc = jpl.gaborish_jax(ycc, jnp.asarray(gab))
        ycc = jpl.epf_jax(ycc, jnp.asarray(isg_px), jnp.asarray(sad), CS,
                          epf, np.float32(0.9), np.float32(6.5))
    return jpl.ycbcr_to_rgb_jax(ycc)[:, :th, :tw]


@pytest.mark.parametrize("mode,filters,true_size", [
    ("420", False, None), ("420", True, (83, 61)), ("422", True, None)])
def test_decode_render_subsampled_matches_jax(mode, filters, true_size):
    """The YCbCr render against the JAX package's stages, whose chroma
    repetition is replaced by libjxl's linear upsampling (_jax_subsampled):
    the JAX package's own render repeats chroma samples, up to 96 u8
    steps from libjxl's pixels at a saturated edge."""
    rng = np.random.default_rng(len(mode) + int(filters))
    shifts = ((1, 1), (0, 0), (1, 1)) if mode == "420" \
        else ((1, 0), (0, 0), (1, 0))
    nby, nbx = 11, 8  # odd, so the chroma planes overhang the luma
    h, w = nby * 8, nbx * 8
    qs, dcs, scaled = _subsampled_inputs(rng, nby, nbx, shifts)
    dm = rng.uniform(3e-3, 0.05, (3, 8, 8)).astype(np.float32)
    gab = np.stack([gaborish_kernel(0.115169525, 0.061248592)] * 3) \
        .astype(np.float32)
    isg = rng.uniform(-2.5, -1.0, (nby, nbx)).astype(np.float32)
    sad = _sad_mul_map(h, w, 2.0 / 3.0).astype(np.float32)
    epf = 2 if filters else 0
    kw = dict(epf_iters=epf, gab=filters, to_u8=False, true_size=true_size)
    got = tpl.decode_render_subsampled(
        [_t(q) for q in qs], [_t(d) for d in dcs], [_t(s) for s in scaled],
        _t(dm), _t(gab), _t(isg), _t(sad), CS, shifts, **kw)
    ref = _jax_subsampled(qs, dcs, scaled, dm, gab,
                          np.repeat(np.repeat(isg, 8, 0), 8, 1), sad,
                          shifts, h, w, epf, filters, true_size)
    assert got.shape == ref.shape == (3, *(true_size or (h, w)))
    _close(got, ref)
    kw["to_u8"] = True
    u8 = tpl.decode_render_subsampled(
        [_t(q) for q in qs], [_t(d) for d in dcs], [_t(s) for s in scaled],
        _t(dm), _t(gab), _t(isg), _t(sad), CS, shifts, **kw).numpy()
    assert u8.dtype == np.uint8 and u8.shape == (*(true_size or (h, w)), 3)
    np.testing.assert_array_equal(
        u8, np.clip(np.round(got.numpy() * 255.0), 0, 255).astype(
            np.uint8).transpose(1, 2, 0))
