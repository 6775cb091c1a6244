"""Encoder statistics + debug images.

Analogs of JxlEncoderStats / JxlEncoderCollectStats (stats.h:36-59,
per-layer bit accounting via enc_aux_out.h AuxOut) and the
JxlEncoderSetDebugImageCallback heatmap dumps (enc_debug_image.*).
"""

from __future__ import annotations

import numpy as np


def collect_stats(writer) -> dict:
    """Per-layer bit accounting of an encode (AuxOut::Assimilate analog).

    Returns {layer: bits} plus "total_bits"; layers: frame_header, toc,
    dc_global, dc_groups, ac_global, ac_groups (VarDCT) or modular
    sections."""
    stats = dict(writer.layer_bits)
    stats["total_bits"] = writer.bits_written()
    accounted = sum(v for k, v in stats.items() if k != "total_bits")
    stats["unaccounted_bits"] = stats["total_bits"] - accounted
    return stats


_HEAT = np.array([
    [0, 0, 64], [0, 64, 160], [0, 160, 192], [64, 208, 96],
    [208, 208, 0], [255, 128, 0], [255, 0, 0], [255, 255, 255]],
    dtype=np.float64)


def heatmap(values: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """Map a 2D field to an RGB uint8 heatmap (DumpHeatmap analog,
    enc_adaptive_quantization.cc:746-767)."""
    v = np.asarray(values, dtype=np.float64)
    lo = float(v.min()) if vmin is None else vmin
    hi = float(v.max()) if vmax is None else vmax
    t = np.clip((v - lo) / max(hi - lo, 1e-9), 0.0, 1.0) * (len(_HEAT) - 1)
    idx = np.minimum(t.astype(int), len(_HEAT) - 2)
    frac = (t - idx)[..., None]
    rgb = _HEAT[idx] * (1 - frac) + _HEAT[idx + 1] * frac
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def save_heatmap(values: np.ndarray, path: str, scale: int = 8) -> None:
    """Write a per-block field (e.g. raw quant field, EPF sharpness,
    AC strategy ids) as an upscaled PNG heatmap."""
    from ..extras.io import save_image

    img = heatmap(values)
    img = np.repeat(np.repeat(img, scale, 0), scale, 1)
    save_image(path, img)
