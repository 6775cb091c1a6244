"""Decoder restoration on the host: Gaborish and EPF.

Mirrors render_pipeline/stage_gaborish.cc and stage_epf.cc + epf.cc
(ComputeSigma); the stencils run in C (native/render_filters.c).
"""

from __future__ import annotations

import functools

import numpy as np

from ..base.status import JXLError

BLOCK_DIM = 8
INV_SIGMA_NUM = -1.1715728752538099  # epf.h:19
MIN_SIGMA = -3.90524291751269967465540850526868  # epf.h:22
SIGMA_PAD_VALUE = 1e10  # "no filtering" sentinel (|1/sigma| tiny)


def gaborish_kernel(w1: float, w2: float) -> np.ndarray:
    """3x3 kernel (stage_gaborish.cc:25-60): center 1, edges w1, corners w2,
    normalized to sum 1."""
    k = np.array([[w2, w1, w2], [w1, 1.0, w1], [w2, w1, w2]])
    return k / (1.0 + 4.0 * (w1 + w2))


def apply_gaborish(xyb, lf):
    """Per-channel 3x3 blur with signaled weights (host path; the TPU
    path lives in parallel.sharding). C stencil (render_filters.c)."""
    from ..native_ext import conv3x3_sym_native, get_lib

    lib = get_lib()
    outs = []
    for c, ch in enumerate("xyb"):
        w1 = getattr(lf, f"gab_{ch}_weight1")
        w2 = getattr(lf, f"gab_{ch}_weight2")
        kern = gaborish_kernel(w1, w2)
        plane = np.asarray(xyb[c])
        got = conv3x3_sym_native(lib, plane, kern)
        if got is None:
            raise JXLError("the native library did not build")
        outs.append(got)
    return np.stack(outs)


def compute_sigma(lf, quant_scale, raw_quant_field, epf_sharpness):
    """epf.cc:39-85: per-block 1/sigma (negative; < MIN_SIGMA means skip)."""
    sharp_lut = np.asarray(lf.epf_sharp_lut)
    sigma_quant = lf.epf_quant_mul / (
        quant_scale * raw_quant_field.astype(np.float64) * INV_SIGMA_NUM)
    sigma = sigma_quant * sharp_lut[epf_sharpness]
    sigma = np.minimum(-1e-4, sigma)
    return (1.0 / sigma).astype(np.float32)


def _sad_mul_map(h, w, border_mul):
    """Per-pixel SAD multiplier: border rows/cols of each 8-block get
    border_mul, others 1 (stage_epf.cc:85-106). Content-independent, so
    cached per geometry."""
    return _sad_mul_map_cached(h, w, float(border_mul))


@functools.lru_cache(maxsize=8)
def _sad_mul_map_cached(h, w, border_mul):
    ys = np.zeros(h, dtype=bool)
    xs = np.zeros(w, dtype=bool)
    ys[0::BLOCK_DIM] = True
    ys[BLOCK_DIM - 1::BLOCK_DIM] = True
    xs[0::BLOCK_DIM] = True
    xs[BLOCK_DIM - 1::BLOCK_DIM] = True
    border = ys[:, None] | xs[None, :]
    return np.where(border, border_mul, 1.0).astype(np.float32)


_PLUS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
_EPF0_NEIGHBORS = ((-2, 0), (-1, -1), (-1, 0), (-1, 1), (0, -2), (0, -1),
                   (0, 1), (0, 2), (1, -1), (1, 0), (1, 1), (2, 0))
_EPF12_NEIGHBORS = ((-1, 0), (0, -1), (0, 1), (1, 0))


# symmetric +/- pair representatives of the neighbor sets above
_EPF0_PAIRS = ((2, 0), (1, 1), (1, 0), (1, -1), (0, 2), (0, 1))
_EPF12_PAIRS = ((1, 0), (0, 1))


def _epf_pass_any(xyb, inv_px, sad_mul, cs, neighbors, pairs, sad_pattern,
                  sigma_scale):
    """One EPF pass: C kernel (render_filters.c)."""
    from ..native_ext import epf_pass_native, get_lib

    got = epf_pass_native(get_lib(), xyb, inv_px, sad_mul, cs, pairs,
                          sad_pattern is not None, sigma_scale, MIN_SIGMA)
    if got is None:
        raise JXLError("the native library did not build")
    return got


def apply_epf(xyb, lf, inv_sigma_blocks):
    """EPF iterations per loop_filter.epf_iters (stage_epf.cc).

    inv_sigma_blocks: (nby, nbx) per-block 1/sigma from compute_sigma.
    """
    h, w = xyb.shape[-2:]
    nby, nbx = inv_sigma_blocks.shape
    inv_px = np.repeat(np.repeat(
        np.asarray(inv_sigma_blocks, dtype=np.float64),
        BLOCK_DIM, 0), BLOCK_DIM, 1)[:h, :w]
    sad_mul = _sad_mul_map(h, w, lf.epf_border_sad_mul)
    cs = lf.epf_channel_scale
    if lf.epf_iters == 3:
        xyb = _epf_pass_any(xyb, inv_px, sad_mul, cs, _EPF0_NEIGHBORS,
                            _EPF0_PAIRS, _PLUS, lf.epf_pass0_sigma_scale)
    if lf.epf_iters >= 1:
        xyb = _epf_pass_any(xyb, inv_px, sad_mul, cs, _EPF12_NEIGHBORS,
                            _EPF12_PAIRS, _PLUS, 1.0)
    if lf.epf_iters >= 2:
        xyb = _epf_pass_any(xyb, inv_px, sad_mul, cs, _EPF12_NEIGHBORS,
                            _EPF12_PAIRS, None, lf.epf_pass2_sigma_scale)
    return xyb


def mirror_fill_padding(xyb, ysize: int, xsize: int):
    """Overwrite block-padding rows/cols with the symmetric mirror of the
    true frame content. The reference render pipeline mirrors filters at
    the FRAME edge (image_ops.h:184 Mirror), not at the padded edge, so
    the coded padding pixels must not leak into filter windows."""
    H, W = xyb.shape[-2], xyb.shape[-1]
    if ysize < H:
        n = min(H - ysize, ysize)
        # reversed slice from row ysize-1 down; the stop must be None
        # (not a negative index) when the reflection reaches row 0 —
        # a conditional binding to the STEP instead used to copy
        # forward rows (pre-mirror padding) for tiny images
        stop = ysize - 1 - n
        src = xyb[..., ysize - 1:(stop if stop >= 0 else None):-1, :]
        xyb[..., ysize:ysize + n, :] = src[..., :n, :]
        if ysize + n < H:  # degenerate: padding deeper than the image
            xyb[..., ysize + n:, :] = xyb[..., ysize - 1:ysize, :]
    if xsize < W:
        n = min(W - xsize, xsize)
        stop = xsize - 1 - n
        src = xyb[..., :, xsize - 1:(stop if stop >= 0 else None):-1]
        xyb[..., :, xsize:xsize + n] = src[..., :, :n]
        if xsize + n < W:
            xyb[..., :, xsize + n:] = xyb[..., :, xsize - 1:xsize]
    return xyb


def apply_restoration(xyb_np, fh, state):
    """NumPy-in/NumPy-out restoration used by the host decoder (no device
    dependency; the TPU-resident variant lives in parallel.sharding)."""
    lf = fh.loop_filter
    xyb = np.asarray(xyb_np, dtype=np.float64)
    fd = getattr(state, "fd", None)
    if fd is not None:
        xyb = mirror_fill_padding(np.array(xyb), fd.ysize, fd.xsize)
    if lf.gab:
        xyb = apply_gaborish(xyb, lf)
    if lf.epf_iters > 0:
        inv_sigma = compute_sigma(lf, state.quantizer.global_scale_float,
                                  state.raw_quant_field, state.epf_sharpness)
        xyb = apply_epf(xyb, lf, inv_sigma)
    return xyb
