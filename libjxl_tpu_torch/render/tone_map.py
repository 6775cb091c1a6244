"""Tone mapping + HDR transfer functions.

Mirrors lib/jxl/cms/tone_mapping-inl.h (Rec2408ToneMapper, HLG OOTF) and
cms/transfer_functions-inl.h (PQ/HLG EOTF pairs); used by the decode
path's tone-mapping stage (stage_tone_mapping.cc) when an HDR stream is
rendered for an SDR display.
"""

from __future__ import annotations

import numpy as np

# PQ (SMPTE ST 2084) constants
_PQ_M1 = 2610.0 / 16384
_PQ_M2 = 2523.0 / 4096 * 128
_PQ_C1 = 3424.0 / 4096
_PQ_C2 = 2413.0 / 4096 * 32
_PQ_C3 = 2392.0 / 4096 * 32

# Rec.2020 luminance weights (used by Rec.2408 tone mapper)
_LUM_WEIGHTS = np.array([0.2627, 0.6780, 0.0593])


def pq_eotf(e: np.ndarray) -> np.ndarray:
    """PQ signal [0,1] -> luminance in nits (up to 10000)."""
    e = np.clip(e, 0.0, 1.0)
    ep = np.power(e, 1.0 / _PQ_M2)
    num = np.maximum(ep - _PQ_C1, 0.0)
    den = _PQ_C2 - _PQ_C3 * ep
    return 10000.0 * np.power(num / den, 1.0 / _PQ_M1)


def pq_inv_eotf(nits: np.ndarray) -> np.ndarray:
    """Luminance in nits -> PQ signal [0,1]."""
    y = np.clip(np.asarray(nits, dtype=np.float64) / 10000.0, 0.0, 1.0)
    yp = np.power(y, _PQ_M1)
    return np.power((_PQ_C1 + _PQ_C2 * yp) / (1.0 + _PQ_C3 * yp), _PQ_M2)


def hlg_oetf(lin: np.ndarray) -> np.ndarray:
    """HLG OETF: scene-linear [0,1] -> signal [0,1] (BT.2100)."""
    a, b, c = 0.17883277, 0.28466892, 0.55991073
    lin = np.clip(lin, 0.0, None)
    return np.where(lin <= 1.0 / 12, np.sqrt(3.0 * lin),
                    a * np.log(np.maximum(12.0 * lin - b, 1e-12)) + c)


def hlg_inv_oetf(e: np.ndarray) -> np.ndarray:
    a, b, c = 0.17883277, 0.28466892, 0.55991073
    e = np.clip(e, 0.0, 1.0)
    return np.where(e <= 0.5, e * e / 3.0,
                    (np.exp((e - c) / a) + b) / 12.0)


def hlg_ootf(rgb: np.ndarray, peak_nits: float = 1000.0) -> np.ndarray:
    """HLG system gamma: scene light -> display light
    (tone_mapping-inl.h HlgOOTF)."""
    gamma = 1.2 * 1.111 ** np.log2(peak_nits / 1000.0)
    lum = np.tensordot(_LUM_WEIGHTS, rgb, axes=([0], [0]))
    safe = np.maximum(lum, 1e-12)
    return rgb * np.power(safe, gamma - 1.0)[None]


def rec2408_tone_map(rgb: np.ndarray, source_nits: float,
                     target_nits: float = 255.0) -> np.ndarray:
    """Rec. ITU-R BT.2408 HDR->SDR tone mapper
    (tone_mapping-inl.h Rec2408ToneMapper).

    rgb: (3, H, W) linear, 1.0 == source_nits. Returns linear RGB with
    1.0 == target_nits."""
    if source_nits <= target_nits:
        return np.clip(rgb, 0.0, None) * (source_nits / target_nits)
    pq_mastering_min = pq_inv_eotf(0.0)
    pq_mastering_max = pq_inv_eotf(source_nits)
    pq_range = pq_mastering_max - pq_mastering_min
    inv_pq_range = 1.0 / pq_range
    min_lum = (pq_inv_eotf(0.0) - pq_mastering_min) * inv_pq_range
    max_lum = (pq_inv_eotf(target_nits) - pq_mastering_min) * inv_pq_range
    ks = 1.5 * max_lum - 0.5
    b = min_lum

    lum = np.tensordot(_LUM_WEIGHTS, np.maximum(rgb, 0.0),
                       axes=([0], [0])) * source_nits
    norm_lum = (pq_inv_eotf(lum) - pq_mastering_min) * inv_pq_range
    # knee spline (Rec.2408 annex 5)
    t = np.where(norm_lum > ks, (norm_lum - ks) / (1.0 - ks), 0.0)
    t2 = t * t
    t3 = t2 * t
    p = ((2 * t3 - 3 * t2 + 1) * ks + (t3 - 2 * t2 + t) * (1 - ks)
         + (-2 * t3 + 3 * t2) * max_lum)
    mapped = np.where(norm_lum < ks, norm_lum, p)
    mapped = mapped + b * np.power(1.0 - np.clip(mapped, 0, 1), 4.0)
    new_lum = pq_eotf(mapped * pq_range + pq_mastering_min)
    ratio = np.where(lum > 1e-6, new_lum / np.maximum(lum, 1e-6), 0.0)
    return rgb * ratio[None] * (source_nits / target_nits)


def apply_spot_colors(rgb: np.ndarray, extra_planes, extra_channel_info,
                      bit_depth_max: float = 255.0) -> np.ndarray:
    """Render spot-color extra channels into the color image
    (stage_spot.cc:27-37): p = mix*spot + (1-mix)*p with
    mix = spot_alpha * plane."""
    from ..io.headers import EC_SPOT_COLOR

    for k, eci in enumerate(extra_channel_info):
        if eci.type != EC_SPOT_COLOR or k >= len(extra_planes):
            continue
        sc = getattr(eci, "spot_color", None) or [0.0, 0.0, 0.0, 0.0]
        plane = np.asarray(extra_planes[k], dtype=np.float64)
        maxv = (1 << eci.bit_depth.bits_per_sample) - 1
        mix = sc[3] * plane / maxv
        for c in range(3):
            rgb[c] = mix * sc[c] + (1.0 - mix) * rgb[c]
    return rgb
