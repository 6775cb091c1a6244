"""Spline rendering (centripetal Catmull-Rom curves with Gaussian profile).

Codec + renderer for the kSplines image feature. Mirrors splines.cc:
  - ContinuousIDCT (splines.cc:46-70): 32-point cosine interpolation
  - DrawCentripetalCatmullRomSpline (splines.cc:276-316)
  - ForEachEquallySpacedPoint (splines.cc:318-356): arc-length resampling
    at kDesiredRenderingDistance=1
  - QuantizedSpline Create/Dequantize/Decode (splines.cc:363-557)
  - Splines::Decode (splines.cc:570-610), EncodeSplines (enc_splines.cc)
  - ComputeSegments/DrawSegment (splines.cc:73-158): per-point Gaussian
    blobs via the erf-difference separable profile

The reference encoder has no spline detector (enc_splines.cc:94-97
FindSplines is a stub); splines enter through the encode API, so this
module exposes them as an explicit encoder input too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from ..io.fields import pack_signed, unpack_signed

# SplineEntropyContexts (splines.h:33-41)
CTX_QUANT_ADJ = 0
CTX_STARTING_POS = 1
CTX_NUM_SPLINES = 2
CTX_NUM_CONTROL_POINTS = 3
CTX_CONTROL_POINTS = 4
CTX_DCT = 5
NUM_SPLINE_CONTEXTS = 6

DESIRED_RENDERING_DISTANCE = 1.0  # splines.h:29
MAX_NUM_CONTROL_POINTS = 1 << 20
POS_LIMIT = 1 << 23
# X, Y, B, sigma (splines.cc:230)
CHANNEL_WEIGHT = (0.0042, 0.075, 0.07, 1.0 / 3)
SQRT2 = math.sqrt(2.0)
SQRT0_5 = math.sqrt(0.5)


@dataclass
class Spline:
    control_points: np.ndarray          # (N, 2) float, (x, y)
    color_dct: np.ndarray               # (3, 32) float
    sigma_dct: np.ndarray               # (32,) float


@dataclass
class QuantizedSpline:
    control_points: list = field(default_factory=list)  # delta-deltas
    color_dct: np.ndarray = None        # (3, 32) int
    sigma_dct: np.ndarray = None        # (32,) int


@dataclass
class SplinesState:
    quantization_adjustment: int = 0
    starting_points: list = field(default_factory=list)   # (x, y) ints
    splines: list = field(default_factory=list)           # QuantizedSpline


def adjusted_quant(adjustment: int) -> float:
    return (1.0 + 0.125 * adjustment) if adjustment >= 0 \
        else 1.0 / (1.0 - 0.125 * adjustment)


def inv_adjusted_quant(adjustment: int) -> float:
    return 1.0 / (1.0 + 0.125 * adjustment) if adjustment >= 0 \
        else (1.0 - 0.125 * adjustment)


def continuous_idct(dct: np.ndarray, t):
    """DCT-3 cosine interpolation, scaled so {x,0,...} -> constant x
    (splines.cc:46-70). t may be a vector."""
    i = np.arange(32)
    args = (np.pi / 32) * i * (np.asarray(t)[..., None] + 0.5)
    return SQRT2 * np.sum(dct * np.cos(args), axis=-1)


def draw_centripetal_catmull_rom(points: np.ndarray) -> np.ndarray:
    """Upsample control points 16x (splines.cc:276-316)."""
    points = np.asarray(points, dtype=np.float64)
    if len(points) == 0:
        return points.reshape(0, 2)
    if len(points) == 1:
        return points.copy()
    n_per = 16
    ext = np.concatenate([
        (2 * points[0] - points[1])[None], points,
        (2 * points[-1] - points[-2])[None]], axis=0)
    result = []
    for start in range(len(ext) - 3):
        p = ext[start:start + 4]
        result.append(p[1])
        d = np.sqrt(np.hypot(p[1:, 0] - p[:3, 0], p[1:, 1] - p[:3, 1]))
        t = np.concatenate([[0.0], np.cumsum(d)])
        for i in range(1, n_per):
            tt = d[0] + (i / n_per) * d[1]
            a = [p[k] + ((tt - t[k]) / d[k]) * (p[k + 1] - p[k])
                 for k in range(3)]
            b = [a[k] + ((tt - t[k]) / (d[k] + d[k + 1])) * (a[k + 1] - a[k])
                 for k in range(2)]
            result.append(b[0] + ((tt - t[1]) / d[1]) * (b[1] - b[0]))
    result.append(ext[-2])
    return np.asarray(result)


def equally_spaced_points(points: np.ndarray, max_points: int = None):
    """Walk the polyline 1px at a time (splines.cc:318-356).
    Returns list of ((x, y), multiplier). max_points bounds the sampled
    count — control points can legally sit ~2^23 px apart, so without a
    cap a few points demand millions of samples (the reference bounds
    the total spline area, splines.cc total_estimated_area_reached)."""
    out = [(tuple(points[0]), DESIRED_RENDERING_DISTANCE)]
    current = np.array(points[0], dtype=np.float64)
    idx = 0
    n = len(points)
    while idx < n:
        if max_points is not None and len(out) > max_points:
            raise JXLError("spline arc length exceeds the area budget")
        previous = current.copy()
        arclength_from_previous = 0.0
        while True:
            if idx >= n:
                out.append((tuple(previous), arclength_from_previous))
                return out
            nxt = points[idx]
            arclength_to_next = float(np.hypot(*(nxt - previous)))
            if (arclength_from_previous + arclength_to_next
                    >= DESIRED_RENDERING_DISTANCE):
                current = previous + (
                    (DESIRED_RENDERING_DISTANCE - arclength_from_previous)
                    / arclength_to_next) * (nxt - previous)
                out.append((tuple(current), DESIRED_RENDERING_DISTANCE))
                break
            arclength_from_previous += arclength_to_next
            previous = nxt.astype(np.float64)
            idx += 1
    return out


# ------------------------------------------------------------- quantization
def quantize_spline(spline: Spline, quantization_adjustment: int,
                    y_to_x: float, y_to_b: float) -> QuantizedSpline:
    """QuantizedSpline::Create (splines.cc:363-420)."""
    cp = np.round(np.asarray(spline.control_points, dtype=np.float64)) \
        .astype(np.int64)
    deltas = np.diff(cp, axis=0)
    # delta-of-delta: first delta minus 0, then successive differences
    dd = []
    prev = np.array([0, 0], dtype=np.int64)
    for d in deltas:
        dd.append((int(d[0] - prev[0]), int(d[1] - prev[1])))
        prev = d
    q = QuantizedSpline(control_points=dd)
    quant = adjusted_quant(quantization_adjustment)
    inv_quant = inv_adjusted_quant(quantization_adjustment)
    dct_factor = np.where(np.arange(32) == 0, SQRT2, 1.0)
    inv_dct_factor = np.where(np.arange(32) == 0, SQRT0_5, 1.0)
    color_q = np.zeros((3, 32), dtype=np.int64)
    for c in (1, 0, 2):
        factor = y_to_x if c == 0 else 0.0 if c == 1 else y_to_b
        restored_y = color_q[1] * inv_dct_factor * CHANNEL_WEIGHT[1] \
            * inv_quant
        decorrelated = spline.color_dct[c] - factor * restored_y
        color_q[c] = np.round(
            decorrelated * dct_factor * quant / CHANNEL_WEIGHT[c]) \
            .astype(np.int64)
    q.color_dct = color_q
    q.sigma_dct = np.round(
        np.asarray(spline.sigma_dct) * dct_factor * quant
        / CHANNEL_WEIGHT[3]).astype(np.int64)
    return q


def dequantize_spline(q: QuantizedSpline, starting_point,
                      quantization_adjustment: int, y_to_x: float,
                      y_to_b: float) -> Spline:
    """QuantizedSpline::Dequantize (splines.cc:417-509), sans the area
    heuristics (enforced separately in decode_splines for robustness)."""
    x, y = int(round(starting_point[0])), int(round(starting_point[1]))
    pts = [(float(x), float(y))]
    dx = dy = 0
    for (ddx, ddy) in q.control_points:
        dx += ddx
        dy += ddy
        x += dx
        y += dy
        if abs(x) >= POS_LIMIT or abs(y) >= POS_LIMIT:
            raise JXLError("spline coordinates out of bounds")
        pts.append((float(x), float(y)))
    inv_quant = inv_adjusted_quant(quantization_adjustment)
    inv_dct_factor = np.where(np.arange(32) == 0, SQRT0_5, 1.0)
    color = np.zeros((3, 32))
    for c in range(3):
        color[c] = q.color_dct[c] * inv_dct_factor * CHANNEL_WEIGHT[c] \
            * inv_quant
    color[0] += y_to_x * color[1]
    color[2] += y_to_b * color[1]
    sigma = q.sigma_dct * inv_dct_factor * CHANNEL_WEIGHT[3] * inv_quant
    return Spline(np.asarray(pts), color, sigma)


# -------------------------------------------------------------- entropy I/O
def decode_splines(r: BitReader, num_pixels: int) -> SplinesState:
    """Splines::Decode (splines.cc:570-610)."""
    from ..entropy.decode import ANSSymbolReader, decode_histograms

    code, cmap = decode_histograms(r, NUM_SPLINE_CONTEXTS)
    reader = ANSSymbolReader(code, r)
    num_splines = reader.read_hybrid_uint(CTX_NUM_SPLINES, r, cmap)
    max_control_points = min(MAX_NUM_CONTROL_POINTS, num_pixels // 2)
    if num_splines + 1 > max_control_points:
        raise JXLError("too many splines")
    num_splines += 1
    st = SplinesState()
    last_x = last_y = 0
    for i in range(num_splines):
        x = reader.read_hybrid_uint(CTX_STARTING_POS, r, cmap)
        y = reader.read_hybrid_uint(CTX_STARTING_POS, r, cmap)
        if i != 0:
            x = unpack_signed(x) + last_x
            y = unpack_signed(y) + last_y
        if abs(x) >= POS_LIMIT or abs(y) >= POS_LIMIT:
            raise JXLError("spline start out of bounds")
        st.starting_points.append((x, y))
        last_x, last_y = x, y
    st.quantization_adjustment = unpack_signed(
        reader.read_hybrid_uint(CTX_QUANT_ADJ, r, cmap))
    total_cp = num_splines
    for _ in range(num_splines):
        ncp = reader.read_hybrid_uint(CTX_NUM_CONTROL_POINTS, r, cmap)
        total_cp += ncp
        if total_cp > max_control_points:
            raise JXLError("too many control points")
        q = QuantizedSpline()
        for _ in range(ncp):
            a = unpack_signed(reader.read_hybrid_uint(CTX_CONTROL_POINTS,
                                                      r, cmap))
            b = unpack_signed(reader.read_hybrid_uint(CTX_CONTROL_POINTS,
                                                      r, cmap))
            if abs(a) >= (1 << 30) or abs(b) >= (1 << 30):
                raise JXLError("spline delta-delta out of bounds")
            q.control_points.append((a, b))
        dcts = np.zeros((4, 32), dtype=np.int64)
        for j in range(4):
            for i in range(32):
                dcts[j, i] = unpack_signed(
                    reader.read_hybrid_uint(CTX_DCT, r, cmap))
        q.color_dct = dcts[:3]
        q.sigma_dct = dcts[3]
        st.splines.append(q)
    if not reader.check_final_state():
        raise JXLError("splines ANS final state mismatch")
    return st


def encode_splines(st: SplinesState, w: BitWriter) -> None:
    """EncodeSplines (enc_splines.cc:64-92)."""
    from ..entropy.encode import Token, build_and_encode_histograms, \
        write_tokens

    tokens = [Token(CTX_NUM_SPLINES, len(st.splines) - 1)]
    last_x = last_y = 0
    for i, (x, y) in enumerate(st.starting_points):
        if i == 0:
            tokens.append(Token(CTX_STARTING_POS, x))
            tokens.append(Token(CTX_STARTING_POS, y))
        else:
            tokens.append(Token(CTX_STARTING_POS, pack_signed(x - last_x)))
            tokens.append(Token(CTX_STARTING_POS, pack_signed(y - last_y)))
        last_x, last_y = x, y
    tokens.append(Token(CTX_QUANT_ADJ,
                        pack_signed(st.quantization_adjustment)))
    for q in st.splines:
        tokens.append(Token(CTX_NUM_CONTROL_POINTS, len(q.control_points)))
        for (a, b) in q.control_points:
            tokens.append(Token(CTX_CONTROL_POINTS, pack_signed(a)))
            tokens.append(Token(CTX_CONTROL_POINTS, pack_signed(b)))
        for dct in list(q.color_dct) + [q.sigma_dct]:
            for v in dct:
                tokens.append(Token(CTX_DCT, pack_signed(int(v))))
    codes, cmap = build_and_encode_histograms(
        [tokens], NUM_SPLINE_CONTEXTS, w)
    write_tokens(tokens, codes, cmap, w)


# ----------------------------------------------------------------- drawing
def _erf(x):
    """Vectorized erf (Abramowitz & Stegun 7.1.26, |err| < 1.5e-7); the
    reference itself uses a fast polynomial (FastErff)."""
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
                - 0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
    return sign * y


def compute_segments(st: SplinesState, xsize: int, ysize: int,
                     y_to_x: float = 0.0, y_to_b: float = 1.0):
    """InitializeDrawCache (splines.cc:631-700): dequantize, upsample,
    arc-length sample, and produce per-point Gaussian segments."""
    segments = []  # (cx, cy, color3, inv_sigma, sigma_over4_int, maxdist)
    # total-area budget over ALL splines (splines.cc caps
    # total_estimated_area_reached at min(2^18 + 8*pixels, 2^22))
    point_budget = min((1 << 18) + 8 * xsize * ysize, 1 << 22)
    for q, start in zip(st.splines, st.starting_points):
        spline = dequantize_spline(q, start, st.quantization_adjustment,
                                   y_to_x, y_to_b)
        cps = spline.control_points
        if len(cps) > 1 and np.any(np.all(cps[1:] == cps[:-1], axis=1)):
            raise JXLError("identical successive control points in spline")
        upsampled = draw_centripetal_catmull_rom(cps)
        pts = equally_spaced_points(upsampled, max_points=point_budget)
        point_budget -= len(pts)
        if point_budget < 0:
            raise JXLError("total spline area exceeds the budget")
        arc_length = (len(pts) - 2) * DESIRED_RENDERING_DISTANCE \
            + pts[-1][1]
        if arc_length <= 0:
            continue
        progress = np.minimum(
            1.0, np.arange(len(pts)) * DESIRED_RENDERING_DISTANCE
            / arc_length)
        colors = np.stack([continuous_idct(spline.color_dct[c],
                                           31 * progress)
                           for c in range(3)], axis=1)
        sigmas = continuous_idct(spline.sigma_dct, 31 * progress)
        for k, (point, multiplier) in enumerate(pts):
            sigma = float(sigmas[k])
            if not (math.isfinite(sigma) and sigma != 0
                    and math.isfinite(1.0 / sigma)
                    and math.isfinite(multiplier)):
                continue
            max_color = max(0.01, *(abs(colors[k][c] * multiplier)
                                    for c in range(3)))
            dist_exp = 5.0
            maximum_distance = math.sqrt(
                -2 * sigma * sigma
                * (math.log(0.1) * dist_exp - math.log(max_color)))
            segments.append((point[0], point[1], colors[k].copy(),
                             1.0 / sigma, 0.25 * sigma * multiplier,
                             maximum_distance))
    return segments


def draw_segments(xyb: np.ndarray, segments, add: bool = True) -> None:
    """Accumulate all segments into xyb (3, H, W) in place
    (DrawSegment, splines.cc:73-114), vectorized per segment."""
    _, h, w = xyb.shape
    one_over_2s2 = 0.353553391
    for (cx, cy, color, inv_sigma, s4i, maxdist) in segments:
        y0 = max(0, int(round(cy - maxdist)))
        y1 = min(h, int(round(cy + maxdist)) + 1)
        x0 = max(0, int(round(cx - maxdist)))
        x1 = min(w, int(round(cx + maxdist)) + 1)
        if y0 >= y1 or x0 >= x1:
            continue
        dx = np.arange(x0, x1, dtype=np.float64) - cx
        dy = np.arange(y0, y1, dtype=np.float64) - cy
        distance = np.sqrt(dx[None, :] ** 2 + dy[:, None] ** 2)
        factor = _erf((distance * 0.5 + one_over_2s2) * inv_sigma) \
            - _erf((distance * 0.5 - one_over_2s2) * inv_sigma)
        local_intensity = s4i * factor * factor
        for c in range(3):
            contrib = color[c] * local_intensity
            if add:
                xyb[c, y0:y1, x0:x1] += contrib
            else:
                xyb[c, y0:y1, x0:x1] -= contrib


def has_any(st: SplinesState) -> bool:
    return bool(st.splines)
