"""AC strategy: the 27 transform types and their geometry.

Mirrors lib/jxl/ac_strategy.h:35-200 and the natural coefficient order
computation (ac_strategy.cc:20-80).
"""

from __future__ import annotations

import functools

import numpy as np

# Strategy ids (ac_strategy.h:35-79)
(DCT, IDENTITY, DCT2X2, DCT4X4, DCT16X16, DCT32X32, DCT16X8, DCT8X16,
 DCT32X8, DCT8X32, DCT32X16, DCT16X32, DCT4X8, DCT8X4, AFV0, AFV1, AFV2,
 AFV3, DCT64X64, DCT64X32, DCT32X64, DCT128X128, DCT128X64, DCT64X128,
 DCT256X256, DCT256X128, DCT128X256) = range(27)

NUM_STRATEGIES = 27

# covered blocks (ac_strategy.h:148-166)
COVERED_X = (1, 1, 1, 1, 2, 4, 1, 2, 1, 4, 2, 4, 1, 1, 1, 1, 1, 1,
             8, 4, 8, 16, 8, 16, 32, 16, 32)
COVERED_Y = (1, 1, 1, 1, 2, 4, 2, 1, 4, 1, 4, 2, 1, 1, 1, 1, 1, 1,
             8, 8, 4, 16, 16, 8, 32, 32, 16)
LOG2_COVERED = (0, 0, 0, 0, 2, 4, 1, 1, 2, 2, 3, 3, 0, 0, 0, 0, 0, 0,
                6, 5, 5, 8, 7, 7, 10, 9, 9)

# strategy -> order bucket (coeff_order.h:44-47)
STRATEGY_ORDER = (0, 1, 1, 1, 2, 3, 4, 4, 5, 5, 6, 6, 1, 1,
                  1, 1, 1, 1, 7, 8, 8, 9, 10, 10, 11, 12, 12)
NUM_ORDERS = 13

# strategy -> quant table kind (quant_weights.h:345-353)
QUANT_TABLE = (0, 1, 2, 3, 4, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 10, 10,
               11, 12, 12, 13, 14, 14, 15, 16, 16)
NUM_QUANT_TABLES = 17
QUANT_REQUIRED_X = (1, 1, 1, 1, 2, 4, 1, 1, 2, 1, 1, 8, 4, 16, 8, 32, 16)
QUANT_REQUIRED_Y = (1, 1, 1, 1, 2, 4, 2, 4, 4, 1, 1, 8, 8, 16, 16, 32, 32)

STRATEGY_NAMES = (
    "DCT8", "IDENTITY", "DCT2x2", "DCT4x4", "DCT16x16", "DCT32x32",
    "DCT16x8", "DCT8x16", "DCT32x8", "DCT8x32", "DCT32x16", "DCT16x32",
    "DCT4x8", "DCT8x4", "AFV0", "AFV1", "AFV2", "AFV3", "DCT64x64",
    "DCT64x32", "DCT32x64", "DCT128x128", "DCT128x64", "DCT64x128",
    "DCT256x256", "DCT256x128", "DCT128x256")


def coefficient_layout(cy: int, cx: int):
    """CoefficientLayout: returns (rows, cols) with cols >= rows."""
    return (cy, cx) if cx >= cy else (cx, cy)


@functools.lru_cache(maxsize=None)
def natural_coeff_order(strategy: int) -> np.ndarray:
    """order[k] = coefficient position (in cy*8 x cx*8 wide-layout raster)
    of the k-th natural-order coefficient (ac_strategy.cc:20-80)."""
    cx, cy = COVERED_X[strategy], COVERED_Y[strategy]
    cy, cx = coefficient_layout(cy, cx)
    xs = cx // cy
    xsm = xs - 1
    xss = (xs - 1).bit_length()
    side = cx * 8
    out = np.zeros(cx * cy * 64, dtype=np.int32)
    cur = cx * cy
    for i in range(side):
        for j in range(i + 1):
            x, y = j, i - j
            if i % 2:
                x, y = y, x
            if y & xsm:
                continue
            y >>= xss
            if x < cx and y < cy:
                val = y * cx + x
            else:
                val = cur
                cur += 1
            out[val] = y * side + x
    for ip in range(side - 1, 0, -1):
        i = ip - 1
        for j in range(i + 1):
            x = side - 1 - (i - j)
            y = side - 1 - j
            if i % 2:
                x, y = y, x
            if y & xsm:
                continue
            y >>= xss
            out[cur] = y * side + x
            cur += 1
    assert cur == cx * cy * 64
    return out
