"""Encoder heuristics: inverse Gaborish, adaptive quant field, CfL fitting.

- gaborish_inverse mirrors enc_gaborish.cc:21-49 (symmetric-5x5 sharpen
  whose coefficients were butteraugli-optimized in the reference; they are
  format-relevant only through rate/distortion, not bitstream legality).
- initial_quant_field_full is a vectorized reformulation of
  enc_adaptive_quantization.cc InitialQuantField: per-block masking from
  local activity of the Y channel. The reference's full Butteraugli
  feedback loop (FindBestQuantization) hooks in at higher efforts.
- fit_cfl mirrors CfLHeuristics (enc_chroma_from_luma.cc): per 64x64 tile
  least-squares of X (and B-Y) against Y in the DCT-coefficient domain.
"""

from __future__ import annotations

import numpy as np


# kGaborish (enc_gaborish.cc:30-33)
_K_GABORISH = (-0.09495815671340026, -0.041031725066768575,
               0.013710004822696948, 0.006510206083837737,
               -0.0014789063378272242)


def gaborish_inverse_kernel(mul: float = 1.0) -> np.ndarray:
    """5x5 sharpen kernel approximating the inverse of the decoder's 3x3
    Gaborish blur."""
    k0, k1, k2, k3, k4 = _K_GABORISH
    s = 1.0 + mul * 4 * (k0 + k1 + k2 + k4 + 2 * k3)
    s = max(s, 1e-5)
    norm = 1.0 / s
    m = mul * norm
    kern = np.zeros((5, 5))
    kern[2, 2] = norm
    for (dy, dx), w in (
        (((0, 1)), k0), ((1, 1), k1), ((0, 2), k2), ((1, 2), k3),
            ((2, 2), k4)):
        positions = set()
        for sy in (-1, 1):
            for sx in (-1, 1):
                positions.add((2 + sy * dy, 2 + sx * dx))
                positions.add((2 + sy * dx, 2 + sx * dy))
        for (y, x) in positions:
            kern[y, x] = m * w
    return kern


def apply_gaborish_inverse(xyb: np.ndarray) -> np.ndarray:
    """Sharpen all three channels with the inverse kernel (edge padding).

    One C stencil pass per channel (scipy.ndimage, mode='reflect' ==
    symmetric edge padding) instead of 21 full-image numpy temporaries.
    """
    from scipy import ndimage

    kern = gaborish_inverse_kernel(1.0)
    out = np.empty_like(xyb)
    for c in range(3):
        ndimage.correlate(xyb[c], kern, output=out[c], mode="reflect")
    return out


def epf_sharpness_field(y: np.ndarray, nby: int, nbx: int) -> np.ndarray:
    """Per-block EPF sharpness (ComputeARHeuristics,
    enc_heuristics.cc:890-930): the reference fills a uniform 4 except
    at slower-than-wombat tiers, where a per-value reconstruction
    search picks block minima. We match the default; the search is a
    possible slow-tier extension. (An A/B against an activity-derived
    field measured within noise of uniform 4.)"""
    _ = y
    return np.full((nby, nbx), 4, dtype=np.int32)


def fit_cfl(coeffs_x: np.ndarray, coeffs_y: np.ndarray, coeffs_b: np.ndarray,
            nby: int, nbx: int, color_factor: int = 84,
            base_b: float = 1.0):
    """Least-squares per-64x64-tile CfL factors in the coefficient domain.

    coeffs_*: (nby, nbx, 8, 8) dequantization-domain DCT coefficients (AC
    only considered; LLF ignored). Returns (ytox_map, ytob_map) int32 maps
    of shape (ceil(nby/8), ceil(nbx/8)) with values in [-128, 127].
    """
    tby, tbx = -(-nby // 8), -(-nbx // 8)
    ytox = np.zeros((tby, tbx), dtype=np.int32)
    ytob = np.zeros((tby, tbx), dtype=np.int32)
    mask = np.ones((8, 8), dtype=bool)
    mask[0, 0] = False  # exclude LLF
    for ty in range(tby):
        for tx in range(tbx):
            sl = (slice(ty * 8, min((ty + 1) * 8, nby)),
                  slice(tx * 8, min((tx + 1) * 8, nbx)))
            ys = coeffs_y[sl][..., mask].reshape(-1)
            xs = coeffs_x[sl][..., mask].reshape(-1)
            bs = coeffs_b[sl][..., mask].reshape(-1)
            denom = float(np.dot(ys, ys)) + 1e-9
            rx = float(np.dot(xs, ys)) / denom
            rb = float(np.dot(bs, ys)) / denom
            ytox[ty, tx] = int(np.clip(round(rx * color_factor), -128, 127))
            ytob[ty, tx] = int(np.clip(
                round((rb - base_b) * color_factor), -128, 127))
    return ytox, ytob


# --- full InitialQuantField port (enc_adaptive_quantization.cc) ---

_SG_MUL = 226.77216153508914
_SG_MUL2 = 1.0 / 73.377132366608819
_LOG2 = 0.693147181
_SG_RETMUL = _SG_MUL2 * 18.6580932135 * _LOG2
_SG_VOFFSET = 7.7825991679894591


def _ratio_cbrt_gamma(v: np.ndarray, invert: bool = False) -> np.ndarray:
    """RatioOfDerivativesOfCubicRootToSimpleGamma
    (enc_adaptive_quantization.cc:118-137)."""
    eps = 1e-2
    v = np.maximum(v, 0.0)
    num = (_SG_RETMUL * 3 * _SG_MUL) * v * v + eps
    den = (_LOG2 * _SG_MUL) * v * v * v + (_SG_VOFFSET * _LOG2 + eps)
    return num / den if invert else den / num


def _masking_sqrt(v: np.ndarray) -> np.ndarray:
    k_log_offset = 27.505837037000106
    k_mul = 211.66567973503678
    return 0.25 * np.sqrt(v * np.sqrt(k_mul * 1e8) + k_log_offset)


def _compute_mask(v: np.ndarray) -> np.ndarray:
    """ComputeMask rational polynomial (:85-101)."""
    v1 = np.maximum(v * 0.80061762862741759, 1e-3)
    v2 = 1.0 / (v1 + 302.59587815579727)
    v3 = 1.0 / (v1 * v1 + 3.7179635626140772)
    v4 = 1.0 / (v1 * v1 + 0.25 * 3.7179635626140772)
    return (-0.7647 + 9.4708735624378946 * v4 + 17.35036561631863 * v2
            + 6.7943250517376494 * v3)


def _block_sum(img: np.ndarray, nby: int, nbx: int) -> np.ndarray:
    return img[:nby * 8, :nbx * 8].reshape(nby, 8, nbx, 8).sum(axis=(1, 3))


def initial_quant_field_full(xyb: np.ndarray, nby: int, nbx: int,
                             distance: float,
                             rescale: float = 1.0) -> np.ndarray:
    """Float per-block quant field (AdaptiveQuantizationMap,
    enc_adaptive_quantization.cc:480-660 + PerBlockModulations
    :306-340), vectorized. xyb: (3, H, W) opsin planes."""
    quant_ac = 0.725 / max(distance, 1e-3)  # kAcQuant (:843)
    scale = quant_ac * rescale
    h, w = nby * 8, nbx * 8
    yp = xyb[1][:h, :w]
    xp = xyb[0][:h, :w]
    bp = xyb[2][:h, :w]

    # per-pixel masking diff (:510-600)
    p = np.pad(yp, 1, mode="edge")
    base = 0.25 * (p[2:, 1:-1] + p[:-2, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])
    gammac = _ratio_cbrt_gamma(yp + 0.019)
    diff = np.minimum((gammac * (yp - base)) ** 2, 0.2)
    diff = _masking_sqrt(diff)
    # 4x4 cell aggregation * 0.25 -> pre_erosion at half-block res
    pre = diff.reshape(h // 4, 4, w // 4, 4).sum(axis=(1, 3)) * 0.25

    # FuzzyErosion (:380-450): weighted 4 smallest of the 9-neighborhood
    mul = max(0.0, min(1.0, (2.0 - distance) / 2.0)) if distance < 2.0 \
        else 0.0
    k = np.array([0.125 + mul * 0.0, 0.10 - mul * 0.10,
                  0.09 - mul * 0.09, 0.06 - mul * 0.06])
    k *= 0.29959705784054957 / k.sum()
    pp = np.pad(pre, 1, mode="edge")
    hh, ww = pre.shape
    neigh = np.stack([pp[1 + dy:1 + dy + hh, 1 + dx:1 + dx + ww]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    # full sort of the 4 smallest: np.partition leaves slots 0-2 in
    # arbitrary order while the weights k[0..3] differ per rank
    part = np.sort(neigh, axis=0)
    eroded = (k[0] * part[0] + k[1] * part[1] + k[2] * part[2]
              + k[3] * part[3])
    # sum the four half-block cells into each block
    aq = eroded.reshape(nby, 2, nbx, 2).sum(axis=(1, 3))

    out = _compute_mask(aq)

    # HfModulation (:251-300): capped |gradient| sums over the block.
    # Only INTRA-block diffs count: the reference masks the rightmost
    # column's horizontal diff (kMaskRight) and uses the same row for
    # dy == 7, so diffs never cross the 8px block boundary.
    vmin = 0.0206
    dx_ = np.minimum(np.abs(yp[:, 1:] - yp[:, :-1]), vmin)
    dy_ = np.minimum(np.abs(yp[1:, :] - yp[:-1, :]), vmin)
    dx_ = np.pad(dx_, ((0, 0), (0, 1)))
    dy_ = np.pad(dy_, ((0, 1), (0, 0)))
    dx_[:, 7::8] = 0.0
    dy_[7::8, :] = 0.0
    hf = _block_sum(dx_, nby, nbx) + _block_sum(dy_, nby, nbx)
    out = out + hf * -0.38 + 0.42

    # GammaModulation (:170-200)
    r = _ratio_cbrt_gamma(yp + 0.16 - xp, invert=True)
    g = _ratio_cbrt_gamma(yp + 0.16 + xp, invert=True)
    overall = (_block_sum(r, nby, nbx) + _block_sum(g, nby, nbx)) \
        * (0.5 / 64)
    out = out + 0.1005613337192697 * np.log2(np.maximum(overall, 1e-9))

    # BlueModulation (:200-250)
    k_limit = 0.027121074570634722
    k_offset = 0.084381641171960495
    p_y_eff = bp - (yp + k_offset + np.abs(xp))
    contrib = np.where(p_y_eff > 0, np.minimum(p_y_eff, k_limit), 0.0)
    s = _block_sum(contrib, nby, nbx)
    s = np.where(s >= 32 * k_limit, 64 * k_limit - s, s)
    s = np.minimum(s, 15.398788439047934 * k_limit)
    out = out + s * 0.14207000358439159

    # final mapping (:330-340): exp with distance-dependent dampening
    base_level = 0.48 * scale
    if distance >= 2.0:
        dampen = max(0.0, 1.0 - (distance - 2.0) / 12.0)
    else:
        dampen = 1.0
    return np.exp(out) * (scale * dampen) + (1.0 - dampen) * base_level
