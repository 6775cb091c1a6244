"""jpegli adaptive-quantization field (adaptive_quantization.cc).

Same psychovisual pipeline as the reference's ComputeAdaptiveQuantField
(adaptive_quantization.cc:511) — local gamma-corrected contrast,
fuzzy-minimum erosion, then per-block mask/HF/gamma modulations —
computed whole-image with vectorized NumPy instead of the reference's
row-streaming SIMD loops.  Input is the padded Y plane in [0, 255]
(the reference's rows are 0..255 with kInputScaling folded into the
constants; we fold it the same way).

The output per 8x8 block is ``aq_strength = max(0, 0.6/qf - 1)``
(adaptive_quantization.cc:555-559), consumed as the dead-zone
multiplier in the quantizer.
"""

from __future__ import annotations

import numpy as np

_INPUT_SCALING = 1.0 / 255.0

# SimpleGamma constants (adaptive_quantization.cc:194-199).  These are
# jpegli's values; they differ slightly from the VarDCT encoder's
# (vardct/heuristics.py) which is why the module keeps its own copy.
_SG_MUL = 226.0480446705883
_SG_MUL2 = 1.0 / 73.377132366608819
_LOG2 = 0.693147181
_SG_RETMUL = _SG_MUL2 * 18.6580932135 * _LOG2
_SG_VOFFSET = 7.14672470003


def _ratio_cbrt_gamma(v: np.ndarray, invert: bool) -> np.ndarray:
    """RatioOfDerivativesOfCubicRootToSimpleGamma
    (adaptive_quantization.cc:202-227) with 0..255 input scaling."""
    eps = 1e-2
    num_offset = eps / _INPUT_SCALING / _INPUT_SCALING
    num_mul = _SG_RETMUL * 3 * _SG_MUL
    den_offset = (_SG_VOFFSET * _LOG2 + eps) / _INPUT_SCALING
    den_mul = _LOG2 * _SG_MUL * _INPUT_SCALING * _INPUT_SCALING
    v = np.maximum(v, 0.0)
    v2 = v * v
    num = num_mul * v2 + num_offset
    den = den_mul * v * v2 + den_offset
    return num / den if invert else den / num


def _masking_sqrt(v: np.ndarray) -> np.ndarray:
    # adaptive_quantization.cc:358-365
    return 0.25 * np.sqrt(v * np.sqrt(211.50759899638012e8) + 28.0)


def _compute_mask(v: np.ndarray) -> np.ndarray:
    # adaptive_quantization.cc:169-191
    v1 = np.maximum(v * 0.74760422233706747, 1e-3)
    v2 = 1.0 / (v1 + 305.04035728311436)
    v3 = 1.0 / (v1 * v1 + 2.1925739705298404)
    v4 = 1.0 / (v1 * v1 + 0.25 * 2.1925739705298404)
    return (-0.74174993 + 12.906028311180409 * v2
            + 5.0220313103171232 * v3 + 3.2353257320940401 * v4)


def _pre_erosion(y: np.ndarray) -> np.ndarray:
    """ComputePreErosion (adaptive_quantization.cc:434): squared
    gamma-scaled local contrast, 4x4-aggregated.  y is (H, W) padded to
    8-multiples; returns (H/4, W/4)."""
    match_gamma_offset = 0.019 / _INPUT_SCALING
    limit = 0.2
    pad = np.pad(y, 1, mode="edge")
    base = 0.25 * (pad[1:-1, :-2] + pad[1:-1, 2:]
                   + pad[:-2, 1:-1] + pad[2:, 1:-1])
    gammacv = _ratio_cbrt_gamma(y + match_gamma_offset, invert=False)
    diff = gammacv * (y - base)
    diff = np.minimum(diff * diff, limit)
    diff = _masking_sqrt(diff)
    h, w = y.shape
    # sum over each 4-row group, mean over each 4-column group
    return diff.reshape(h // 4, 4, w // 4, 4).sum(axis=1).mean(axis=2)


def _fuzzy_erosion(pre: np.ndarray) -> np.ndarray:
    """FuzzyErosion (adaptive_quantization.cc:390): weighted sum of the
    4 smallest values in each 3x3 neighborhood, then 2x2-aggregated to
    block resolution.  pre is (H/4, W/4); returns (H/8, W/8)."""
    pad = np.pad(pre, 1, mode="edge")
    stack = np.stack([pad[dy:dy + pre.shape[0], dx:dx + pre.shape[1]]
                      for dy in range(3) for dx in range(3)])
    part = np.partition(stack, 3, axis=0)[:4]
    part.sort(axis=0)
    v = (0.125 * part[0] + 0.075 * part[1]
         + 0.06 * part[2] + 0.05 * part[3])
    h2, w2 = pre.shape
    return v.reshape(h2 // 2, 2, w2 // 2, 2).sum(axis=(1, 3))


def _per_block_modulations(qf: np.ndarray, y: np.ndarray,
                           y_quant_01: int) -> np.ndarray:
    """PerBlockModulations (adaptive_quantization.cc:319): mask, HF and
    gamma modulations of the exponent, then exp + quality dampening."""
    nby, nbx = qf.shape
    blocks = y.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3)

    out = _compute_mask(qf)

    # HfModulation: sum of |right-diff| (7 cols x 8 rows) and
    # |down-diff| (8 cols x 8 rows, last row zero)
    dx = np.abs(np.diff(blocks, axis=3)).sum(axis=(2, 3))
    dyy = np.abs(blocks[:, :, 1:, :] - blocks[:, :, :-1, :]).sum(axis=(2, 3))
    out = out + (dx + dyy) * (-2.0052193233688884 * _INPUT_SCALING / 112.0)

    # GammaModulation
    ratio = _ratio_cbrt_gamma(blocks + 0.16 / _INPUT_SCALING, invert=True)
    overall = ratio.sum(axis=(2, 3)) * (_INPUT_SCALING / 64.0)
    out = out + (-0.15526878023684174 * _LOG2) * np.log2(overall)

    ac_quant = 0.841
    base_level = 0.48 * ac_quant
    ramp_start, ramp_end = 9.0, 65.0
    dampen = 1.0
    if y_quant_01 >= ramp_start:
        dampen = max(0.0, 1.0 - (y_quant_01 - ramp_start)
                     / (ramp_end - ramp_start))
    return np.exp(out) * (ac_quant * dampen) + (1.0 - dampen) * base_level


def compute_aq_strength(y: np.ndarray, y_quant_01: int) -> np.ndarray:
    """Padded Y plane in [0, 255], (H, W) with H, W multiples of 8 ->
    per-block dead-zone strength (H/8, W/8) float32."""
    y = np.ascontiguousarray(y, dtype=np.float32)
    pre = _pre_erosion(y)
    qf = _fuzzy_erosion(pre)
    qf = _per_block_modulations(qf, y, y_quant_01)
    return np.maximum(0.0, 0.6 / qf - 1.0).astype(np.float32)
