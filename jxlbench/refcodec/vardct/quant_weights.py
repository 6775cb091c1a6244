"""Dequantization matrices: 17 table kinds, library defaults + computation.

Mirrors lib/jxl/quant_weights.cc: GetQuantWeights radial interpolation
(:123-155), ComputeQuantTable per-mode assembly (:157-355), DecodeDC
(:507-522). Table parameters come from quant_weights_defaults.py
(extracted library constants).
"""

from __future__ import annotations

import functools

import numpy as np

from ..base.status import JXLError
from .ac_strategy import (
    NUM_QUANT_TABLES,
    QUANT_REQUIRED_X,
    QUANT_REQUIRED_Y,
    coefficient_layout,
)
from .quant_weights_defaults import LIBRARY_DEFAULTS

ALMOST_ZERO = 1e-8
# kInvDCQuant (quant_weights.h:295-299)
INV_DC_QUANT = np.array([4096.0, 512.0, 256.0], dtype=np.float32)
DC_QUANT = 1.0 / INV_DC_QUANT

AFV_FREQS = [0.0, 0.0, 0.8517778890324296, 5.37778436506804,
             0.0, 0.0, 4.734747904497923, 5.449245381693219,
             1.6598270267479331, 4.0, 7.275749096817861, 10.423227632456525,
             2.662932286148962, 7.630657783650829, 8.962388608184032,
             12.97166202570235]


def _mult(v: float) -> float:
    return 1.0 + v if v > 0 else 1.0 / (1.0 - v)


def _interpolate(pos, maxv, array):
    """Log-linear interpolation (quant_weights.cc:86-94), vectorized."""
    pos = np.asarray(pos, dtype=np.float64)
    scaled = pos * (len(array) - 1) / maxv
    idx = np.minimum(scaled.astype(np.int64), len(array) - 2)
    frac = scaled - idx
    arr = np.asarray(array, dtype=np.float64)
    a = arr[idx]
    b = arr[np.minimum(idx + 1, len(array) - 1)]
    return a * np.power(b / a, frac)


def get_quant_weights(rows: int, cols: int, distance_bands) -> np.ndarray:
    """GetQuantWeights (quant_weights.cc:123-155): (3, rows, cols) weights."""
    out = np.zeros((3, rows, cols))
    for c in range(3):
        db = distance_bands[c]
        bands = [db[0]]
        if bands[0] < ALMOST_ZERO:
            raise JXLError("invalid distance bands")
        for i in range(1, len(db)):
            bands.append(bands[-1] * _mult(db[i]))
            if bands[-1] < ALMOST_ZERO:
                raise JXLError("invalid distance bands")
        num_bands = len(db)
        scale = (num_bands - 1) / (np.sqrt(2.0) + 1e-6)
        rcpcol = scale / (cols - 1) if cols > 1 else 0.0
        rcprow = scale / (rows - 1) if rows > 1 else 0.0
        dy = np.arange(rows)[:, None] * rcprow
        dx = np.arange(cols)[None, :] * rcpcol
        dist = np.sqrt(dx * dx + dy * dy)
        if num_bands == 1:
            out[c] = bands[0]
        else:
            out[c] = _interpolate_banded(dist, bands)
    return out


def _interpolate_banded(scaled_distance, bands):
    """InterpolateVec semantics: scaled_distance is already in band units
    (quant_weights.cc:103-121)."""
    arr = np.asarray(bands, dtype=np.float64)
    idx = scaled_distance.astype(np.int64)
    idx = np.minimum(idx, len(bands) - 2)
    frac = scaled_distance - idx
    a = arr[idx]
    b = arr[idx + 1]
    return a * np.power(b / a, frac)


def compute_quant_table(entry, kind: int) -> np.ndarray:
    """ComputeQuantTable (quant_weights.cc:157-355): (3, rows*8, cols*8)
    weights (NOT inverted; dequant matrix = 1/weights)."""
    wrows = 8 * QUANT_REQUIRED_X[kind]
    wcols = 8 * QUANT_REQUIRED_Y[kind]
    mode = entry[0]
    if mode == "dct":
        weights = get_quant_weights(wrows, wcols, entry[1])
    elif mode == "id":
        weights = np.zeros((3, 8, 8))
        for c in range(3):
            weights[c, :, :] = entry[1][c][0]
            weights[c, 0, 1] = entry[1][c][1]
            weights[c, 1, 0] = entry[1][c][1]
            weights[c, 1, 1] = entry[1][c][2]
    elif mode == "dct2":
        weights = np.zeros((3, 8, 8))
        for c in range(3):
            w = entry[1][c]
            ww = weights[c]
            ww[0, 0] = 0xBAD  # sentinel as in the reference; LLF, unused
            ww[0, 1] = ww[1, 0] = w[0]
            ww[1, 1] = w[1]
            ww[0:2, 2:4] = w[2]
            ww[2:4, 0:2] = w[2]
            ww[2:4, 2:4] = w[3]
            ww[0:4, 4:8] = w[4]
            ww[4:8, 0:4] = w[4]
            ww[4:8, 4:8] = w[5]
    elif mode == "dct4":
        w4 = get_quant_weights(4, 4, entry[1])
        weights = np.repeat(np.repeat(w4, 2, axis=1), 2, axis=2)
        for c in range(3):
            weights[c, 0, 1] /= entry[2][c][0]
            weights[c, 1, 0] /= entry[2][c][0]
            weights[c, 1, 1] /= entry[2][c][1]
    elif mode == "dct4x8":
        w48 = get_quant_weights(4, 8, entry[1])
        weights = np.repeat(w48, 2, axis=1)
        for c in range(3):
            weights[c, 1, 0] /= entry[2][c]
    elif mode == "afv":
        w4x8 = get_quant_weights(4, 8, entry[1])
        w4x4 = get_quant_weights(4, 4, entry[2])
        weights = np.zeros((3, 8, 8))
        lo = 0.8517778890324296
        hi = 12.97166202570235 - lo + 1e-6
        for c in range(3):
            aw = entry[3][c]
            bands = [aw[5]]
            for i in range(1, 4):
                bands.append(bands[-1] * _mult(aw[5 + i]))
            ww = weights[c]
            ww[0, 0] = 1.0  # unused (LLF)
            ww[1, 0] = aw[0]
            ww[0, 1] = aw[1]
            ww[2, 0] = aw[2]
            ww[0, 2] = aw[3]
            ww[2, 2] = aw[4]
            for y in range(4):
                for x in range(4):
                    if x < 2 and y < 2:
                        continue
                    val = _interpolate(np.array(AFV_FREQS[y * 4 + x] - lo),
                                       hi, bands)
                    ww[2 * y, 2 * x] = float(val)
            for y in range(4):
                for x in range(8):
                    if x == 0 and y == 0:
                        continue
                    ww[2 * y + 1, x] = w4x8[c, y, x]
            for y in range(4):
                for x in range(4):
                    if x == 0 and y == 0:
                        continue
                    ww[2 * y, 2 * x + 1] = w4x4[c, y, x]
    else:
        raise JXLError(f"unknown quant mode {mode}")
    if np.any(weights < ALMOST_ZERO) or np.any(weights >= 1.0 / ALMOST_ZERO):
        raise JXLError("invalid quantization table")
    return weights


@functools.lru_cache(maxsize=1)
def library_tables():
    """-> list of 17 (dequant, inv_dequant) pairs, each (3, rows*8, cols*8)
    float32; inv_dequant LLF entries zeroed (quant_weights.cc:341-353)."""
    out = []
    for kind in range(NUM_QUANT_TABLES):
        weights = compute_quant_table(LIBRARY_DEFAULTS[kind], kind)
        dequant = (1.0 / weights).astype(np.float32)
        inv = weights.astype(np.float32).copy()
        xs, ys = QUANT_REQUIRED_X[kind], QUANT_REQUIRED_Y[kind]
        ys2, xs2 = coefficient_layout(ys, xs)
        inv[:, :ys2, :xs2] = 0  # LLF region in wide layout
        out.append((dequant, inv))
    return out


# QuantEncoding::Mode (quant_weights.h:59-67)
MODE_LIBRARY = 0
MODE_ID = 1
MODE_DCT2 = 2
MODE_DCT4 = 3
MODE_DCT4X8 = 4
MODE_AFV = 5
MODE_DCT = 6
MODE_RAW = 7

LOG2_NUM_QUANT_MODES = 3
LOG2_MAX_DISTANCE_BANDS = 4


class DequantMatrices:
    """Runtime dequant matrix set: the library defaults
    (quant_weights.cc:382-505)."""

    def __init__(self):
        self.tables = list(library_tables())
        self.dc_quant = DC_QUANT.copy()
        self.inv_dc_quant = INV_DC_QUANT.copy()

    def dequant_matrix(self, kind: int, c: int) -> np.ndarray:
        return self.tables[kind][0][c]

    def inv_matrix(self, kind: int, c: int) -> np.ndarray:
        return self.tables[kind][1][c]

    def decode_dc(self, r) -> None:
        """quant_weights.cc:507-522: the default DC steps only."""
        if not r.read_bits(1):
            raise JXLError("custom DC quant steps: not in this copy")

    def encode_dc(self, w) -> None:
        w.write(1, 1)  # all_default

    def decode(self, r) -> None:
        """DequantMatrices::Decode (quant_weights.cc:382-505): the library
        tables only."""
        if r.read_bits(1) != 1:
            raise JXLError("custom dequant tables: not in this copy")

    def encode(self, w) -> None:
        w.write(1, 1)  # all_default
