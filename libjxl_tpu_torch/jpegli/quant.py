"""jpegli quantization-table construction.

Behavioral parity with the reference's quant.cc (SetQuantMatrices
quant.cc:635, InitQuantizer quant.cc:706): distance-scaled
psychovisual base tables with a per-frequency nonlinearity, plus the
adaptive-quantization zero-bias (dead-zone) parameters.  Tables are
returned in NATURAL (row-major) coefficient order; callers zigzag them
when building the bitstream.
"""

from __future__ import annotations

import numpy as np

from .tables import (
    BASE_QUANT_STD,
    BASE_QUANT_XYB,
    BASE_QUANT_YCBCR,
    DIST_EXPONENT,
    RESCALE_420,
    ZERO_BIAS_MUL_HQ,
    ZERO_BIAS_MUL_LQ,
    ZERO_BIAS_OFFSET_AC,
    ZERO_BIAS_OFFSET_DC,
)

# Global scales fitted so butteraugli 3-norm matches libjpeg at the
# same quality setting (quant.cc:26-27,425).
GLOBAL_SCALE_XYB = 1.43951668
GLOBAL_SCALE_YCBCR = 1.73966010
GLOBAL_SCALE_420 = 1.22

_DIST0 = 1.5  # distance where the per-frequency nonlinearity starts


def quality_to_distance(quality: int) -> float:
    """libjpeg quality (1-100) -> butteraugli distance
    (jpegli_quality_to_distance, encode.cc:838)."""
    quality = int(quality)
    if quality >= 100:
        return 0.01
    if quality >= 30:
        return 0.1 + (100 - quality) * 0.09
    return 53.0 / 3000.0 * quality * quality - 23.0 / 20.0 * quality + 25.0


def distance_to_linear_quality(distance: float) -> float:
    """Distance -> libjpeg linear quality scale, used for the Annex-K
    standard-table mode (quant.cc:529)."""
    if distance <= 0.1:
        return 1.0
    if distance <= 4.6:
        return (200.0 / 9.0) * (distance - 0.1)
    if distance <= 6.4:
        return 5000.0 / (100.0 - (distance - 0.1) / 0.09)
    if distance < 25.0:
        return 530000.0 / (
            3450.0 - 300.0 * np.sqrt((848.0 * distance - 5330.0) / 120.0))
    return 5000.0


def distance_to_scale(distance: float) -> np.ndarray:
    """Per-coefficient scale factors for one distance (quant.cc:557):
    linear below distance 1.5, then a fitted sub-linear power ramp per
    frequency.  Returns (64,) in natural order."""
    d = float(distance)
    if d < _DIST0:
        return np.full(64, d)
    exp = DIST_EXPONENT
    mul = _DIST0 ** (1.0 - exp)
    return np.maximum(0.5 * d, mul * d ** exp)


def scale_to_distance(scale: float, k: int) -> float:
    """Inverse of distance_to_scale for one coefficient (quant.cc:566)."""
    s = float(scale)
    if s < _DIST0:
        return s
    exp = 1.0 / DIST_EXPONENT[k]
    mul = _DIST0 ** (1.0 - exp)
    return min(2.0 * s, mul * s ** exp)


def make_quant_tables(distance: float, *, color: str = "ycbcr",
                      subsampling: str = "444", std_tables: bool = False,
                      force_baseline: bool = True) -> np.ndarray:
    """Build the quantization tables (SetQuantMatrices, quant.cc:635).

    Returns (n, 64) uint16 in NATURAL order: n=3 for ycbcr/xyb
    (separate Cb and Cr tables), n=2 for std tables or grayscale use.
    """
    is_420 = subsampling == "420"
    if color == "xyb":
        global_scale = GLOBAL_SCALE_XYB
        base = BASE_QUANT_XYB
        nonlinear = True
    elif color == "ycbcr" and not std_tables:
        global_scale = GLOBAL_SCALE_YCBCR
        if is_420:
            global_scale *= GLOBAL_SCALE_420
        base = BASE_QUANT_YCBCR
        nonlinear = True
    else:
        global_scale = 0.01
        base = BASE_QUANT_STD
        nonlinear = False

    quant_max = 255 if force_baseline else 32767
    tables = np.empty((base.shape[0], 64), dtype=np.uint16)
    for idx in range(base.shape[0]):
        scale = np.full(64, global_scale)
        if nonlinear:
            scale = scale * distance_to_scale(distance)
            if is_420 and idx > 0:
                scale = scale * RESCALE_420
        else:
            scale = scale * distance_to_linear_quality(distance)
        qval = np.round(scale * base[idx])
        tables[idx] = np.clip(qval, 1, quant_max).astype(np.uint16)
    return tables


def quantvals_to_distance(tables: np.ndarray, base: np.ndarray,
                          global_scale: float) -> float:
    """Estimate the butteraugli distance that produced the given quant
    tables (QuantValsToDistance, quant.cc:575); drives the LQ/HQ
    zero-bias interpolation."""
    dist_max_const = 10000.0
    dist_min = 0.0
    dist_max = dist_max_const
    for idx in range(tables.shape[0]):
        invq = 1.0 / (base[idx] * global_scale)
        for k in range(64):
            qval = int(tables[idx, k])
            dmin, dmax = 0.0, dist_max_const
            if qval > 1:
                dmin = scale_to_distance((qval - 0.5) * invq[k], k)
            if qval < 255:
                dmax = scale_to_distance((qval + 0.5) * invq[k], k)
            if dmin <= dist_max:
                dist_min = max(dmin, dist_min)
            if dmax >= dist_min:
                dist_max = min(dist_max, dmax)
    if dist_min == 0:
        return dist_max
    if dist_max == dist_max_const:
        return dist_min
    return 0.5 * (dist_min + dist_max)


def zero_bias_params(tables: np.ndarray, *, color: str = "ycbcr",
                     adaptive: bool = True):
    """Dead-zone thresholds (InitQuantizer, quant.cc:706): per channel
    and coefficient, threshold = offset + mul * aq_strength.  Returns
    (offset, mul), each (3, 64) float32 in natural order."""
    n = 3
    offset = np.zeros((n, 64), dtype=np.float32)
    mul = np.zeros((n, 64), dtype=np.float32)
    if adaptive:
        mul[:, 1:] = 0.5
        offset[:, 1:] = 0.5
    if color == "ycbcr":
        dist = quantvals_to_distance(
            tables, BASE_QUANT_YCBCR[:tables.shape[0]], GLOBAL_SCALE_YCBCR)
        if adaptive:
            mix0 = min(1.0, max(0.0, (dist - 1.0) / (3.0 - 1.0)))
            mix1 = 1.0 - mix0
            mul = (mix0 * ZERO_BIAS_MUL_LQ + mix1 * ZERO_BIAS_MUL_HQ) \
                .astype(np.float32)
        offset[:, 0] = ZERO_BIAS_OFFSET_DC
        offset[:, 1:] = ZERO_BIAS_OFFSET_AC[:, None]
    return offset, mul
