"""VarDCT pixel<->coefficient transforms for all 27 strategies.

Mirrors dec_transforms-inl.h (TransformToPixels, LowestFrequenciesFromDC)
and enc_transforms-inl.h (TransformFromPixels, DCFromLowestFrequencies).
NumPy reference implementation; the batched TPU path for the hot sizes
lives in libjxl_tpu.ops (MXU matmul DCTs).

Coefficient storage: wide layout (cy*8 rows, cx*8 cols with cx >= cy),
flattened row-major into covered_blocks*64 floats; position [0..cx*cy) of
the natural order are the LLF values (derived from DC, not coded).
"""

from __future__ import annotations

import numpy as np

from ..base.status import JXLError
from ..ops.dct import dct2d, idct2d, resample_scales
from . import ac_strategy as acs


def _idct2_top(block: np.ndarray, s: int) -> None:
    """IDCT2TopBlock (dec_transforms-inl.h:62-88), in place on 8x8."""
    num = s // 2
    c00 = block[:num, :num].copy()
    c01 = block[:num, num:2 * num].copy()
    c10 = block[num:2 * num, :num].copy()
    c11 = block[num:2 * num, num:2 * num].copy()
    block[0:s:2, 0:s:2] = c00 + c01 + c10 + c11
    block[0:s:2, 1:s:2] = c00 + c01 - c10 - c11
    block[1:s:2, 0:s:2] = c00 - c01 + c10 - c11
    block[1:s:2, 1:s:2] = c00 - c01 - c10 + c11


def _dct2_top(block: np.ndarray, s: int) -> None:
    """Forward of _idct2_top (enc_transforms-inl.h DCT2TopBlock)."""
    num = s // 2
    r00 = block[0:s:2, 0:s:2].copy()
    r01 = block[0:s:2, 1:s:2].copy()
    r10 = block[1:s:2, 0:s:2].copy()
    r11 = block[1:s:2, 1:s:2].copy()
    block[:num, :num] = (r00 + r01 + r10 + r11) * 0.25
    block[:num, num:2 * num] = (r00 + r01 - r10 - r11) * 0.25
    block[num:2 * num, :num] = (r00 - r01 + r10 - r11) * 0.25
    block[num:2 * num, num:2 * num] = (r00 - r01 - r10 + r11) * 0.25


def transform_to_pixels(strategy: int, coefficients: np.ndarray) -> np.ndarray:
    """coefficients: (cy*8, cx*8) wide layout -> pixels (rows, cols)."""
    cx, cy = acs.COVERED_X[strategy], acs.COVERED_Y[strategy]
    rows, cols = cy * 8, cx * 8
    co = coefficients
    S = acs
    if strategy == S.DCT:
        return idct2d(co, 8, 8)
    if strategy in (S.DCT16X16, S.DCT32X32, S.DCT64X64, S.DCT128X128,
                    S.DCT256X256, S.DCT16X8, S.DCT8X16, S.DCT32X8, S.DCT8X32,
                    S.DCT32X16, S.DCT16X32, S.DCT64X32, S.DCT32X64,
                    S.DCT128X64, S.DCT64X128, S.DCT256X128, S.DCT128X256):
        return idct2d(co, rows, cols)
    if strategy == S.IDENTITY:
        out = np.zeros((8, 8))
        b00, b01, b10, b11 = co[0, 0], co[0, 1], co[1, 0], co[1, 1]
        dcs = [b00 + b01 + b10 + b11, b00 + b01 - b10 - b11,
               b00 - b01 + b10 - b11, b00 - b01 - b10 + b11]
        for y in range(2):
            for x in range(2):
                block_dc = dcs[y * 2 + x]
                residual_sum = 0.0
                for iy in range(4):
                    for ix in range(4):
                        if ix == 0 and iy == 0:
                            continue
                        residual_sum += co[y + iy * 2, x + ix * 2]
                center = block_dc - residual_sum / 16.0
                out[4 * y + 1, 4 * x + 1] = center
                for iy in range(4):
                    for ix in range(4):
                        if ix == 1 and iy == 1:
                            continue
                        out[y * 4 + iy, x * 4 + ix] = \
                            co[y + iy * 2, x + ix * 2] + center
                out[y * 4, x * 4] = co[y + 2, x + 2] + center
        return out
    if strategy == S.DCT8X4:
        out = np.zeros((8, 8))
        b0, b1 = co[0, 0], co[1, 0]
        dcs = [b0 + b1, b0 - b1]
        for x in range(2):
            block = np.zeros((4, 8))
            for iy in range(4):
                for ix in range(8):
                    if ix == 0 and iy == 0:
                        continue
                    block[iy, ix] = co[x + iy * 2, ix]
            block[0, 0] = dcs[x]
            out[:, x * 4:(x + 1) * 4] = idct2d(block, 8, 4)
        return out
    if strategy == S.DCT4X8:
        out = np.zeros((8, 8))
        b0, b1 = co[0, 0], co[1, 0]
        dcs = [b0 + b1, b0 - b1]
        for y in range(2):
            block = np.zeros((4, 8))
            for iy in range(4):
                for ix in range(8):
                    if ix == 0 and iy == 0:
                        continue
                    block[iy, ix] = co[y + iy * 2, ix]
            block[0, 0] = dcs[y]
            out[y * 4:(y + 1) * 4, :] = idct2d(block, 4, 8)
        return out
    if strategy == S.DCT4X4:
        out = np.zeros((8, 8))
        b = [[co[0, 0], co[0, 1]], [co[1, 0], co[1, 1]]]
        dcs = [b[0][0] + b[0][1] + b[1][0] + b[1][1],
               b[0][0] + b[0][1] - b[1][0] - b[1][1],
               b[0][0] - b[0][1] + b[1][0] - b[1][1],
               b[0][0] - b[0][1] - b[1][0] + b[1][1]]
        for y in range(2):
            for x in range(2):
                block = np.zeros((4, 4))
                for iy in range(4):
                    for ix in range(4):
                        if ix == 0 and iy == 0:
                            continue
                        block[iy, ix] = co[y + iy * 2, x + ix * 2]
                block[0, 0] = dcs[y * 2 + x]
                out[y * 4:(y + 1) * 4, x * 4:(x + 1) * 4] = idct2d(block, 4, 4)
        return out
    if strategy == S.DCT2X2:
        block = co.copy()
        _idct2_top(block, 2)
        _idct2_top(block, 4)
        _idct2_top(block, 8)
        return block
    raise JXLError(f"strategy {strategy} (AFV): not in this copy")


def transform_from_pixels(strategy: int, pixels: np.ndarray) -> np.ndarray:
    """Forward transform: pixels (rows, cols) -> wide-layout coefficients.
    Mirrors enc_transforms-inl.h TransformFromPixels."""
    cx, cy = acs.COVERED_X[strategy], acs.COVERED_Y[strategy]
    rows, cols = cy * 8, cx * 8
    S = acs
    if strategy == S.DCT or strategy in (
            S.DCT16X16, S.DCT32X32, S.DCT64X64, S.DCT128X128, S.DCT256X256,
            S.DCT16X8, S.DCT8X16, S.DCT32X8, S.DCT8X32, S.DCT32X16,
            S.DCT16X32, S.DCT64X32, S.DCT32X64, S.DCT128X64, S.DCT64X128,
            S.DCT256X128, S.DCT128X256):
        return dct2d(pixels)
    if strategy == S.IDENTITY:
        # enc_transforms-inl.h:458-488: residuals relative to the (1,1)
        # center pixel; quadrant DC = mean; (0,0) residual stored at (y+2,x+2)
        co = np.zeros((8, 8))
        for y in range(2):
            for x in range(2):
                block_dc = pixels[y * 4:(y + 1) * 4, x * 4:(x + 1) * 4].mean()
                center = pixels[y * 4 + 1, x * 4 + 1]
                for iy in range(4):
                    for ix in range(4):
                        if ix == 1 and iy == 1:
                            continue
                        co[y + iy * 2, x + ix * 2] = \
                            pixels[y * 4 + iy, x * 4 + ix] - center
                co[y + 2, x + 2] = co[y, x]
                co[y, x] = block_dc
        b00, b01, b10, b11 = co[0, 0], co[0, 1], co[1, 0], co[1, 1]
        co[0, 0] = (b00 + b01 + b10 + b11) / 4
        co[0, 1] = (b00 + b01 - b10 - b11) / 4
        co[1, 0] = (b00 - b01 + b10 - b11) / 4
        co[1, 1] = (b00 - b01 - b10 + b11) / 4
        return co
    if strategy == S.DCT8X4:
        co = np.zeros((8, 8))
        dcs = [0.0, 0.0]
        for x in range(2):
            block = dct2d(pixels[:, x * 4:(x + 1) * 4])  # (4, 8) wide
            dcs[x] = block[0, 0]
            for iy in range(4):
                for ix in range(8):
                    if ix == 0 and iy == 0:
                        continue
                    co[x + iy * 2, ix] = block[iy, ix]
        co[0, 0] = (dcs[0] + dcs[1]) * 0.5
        co[1, 0] = (dcs[0] - dcs[1]) * 0.5
        return co
    if strategy == S.DCT4X8:
        co = np.zeros((8, 8))
        dcs = [0.0, 0.0]
        for y in range(2):
            block = dct2d(pixels[y * 4:(y + 1) * 4, :])
            dcs[y] = block[0, 0]
            for iy in range(4):
                for ix in range(8):
                    if ix == 0 and iy == 0:
                        continue
                    co[y + iy * 2, ix] = block[iy, ix]
        co[0, 0] = (dcs[0] + dcs[1]) * 0.5
        co[1, 0] = (dcs[0] - dcs[1]) * 0.5
        return co
    if strategy == S.DCT4X4:
        co = np.zeros((8, 8))
        dcs = [0.0] * 4
        for y in range(2):
            for x in range(2):
                block = dct2d(pixels[y * 4:(y + 1) * 4, x * 4:(x + 1) * 4])
                dcs[y * 2 + x] = block[0, 0]
                for iy in range(4):
                    for ix in range(4):
                        if ix == 0 and iy == 0:
                            continue
                        co[y + iy * 2, x + ix * 2] = block[iy, ix]
        co[0, 0] = (dcs[0] + dcs[1] + dcs[2] + dcs[3]) * 0.25
        co[0, 1] = (dcs[0] + dcs[1] - dcs[2] - dcs[3]) * 0.25
        co[1, 0] = (dcs[0] - dcs[1] + dcs[2] - dcs[3]) * 0.25
        co[1, 1] = (dcs[0] - dcs[1] - dcs[2] + dcs[3]) * 0.25
        return co
    if strategy == S.DCT2X2:
        block = pixels.astype(np.float64).copy()
        _dct2_top(block, 8)
        _dct2_top(block, 4)
        _dct2_top(block, 2)
        return block
    raise JXLError(f"strategy {strategy} (AFV): not in this copy")


def lowest_frequencies_from_dc(strategy: int, dc: np.ndarray) -> np.ndarray:
    """LowestFrequenciesFromDC (dec_transforms-inl.h:688-816).

    dc: (cy, cx) DC values covering the block -> (cy, cx) LLF coefficients
    to place at wide-layout positions [:cy2, :cx2]."""
    cx, cy = acs.COVERED_X[strategy], acs.COVERED_Y[strategy]
    if cx == 1 and cy == 1:
        return dc.copy()
    # ReinterpretingDCT: DCT of the cy x cx DC block, scaled per axis by
    # DCTTotalResampleScale<ROWS, DCT_ROWS> — the *upsampling* scales,
    # i.e. reciprocals of the downsampling cosines (dct_scales.h:139-233).
    coeffs = dct2d(dc.astype(np.float64))  # wide layout (min, max)
    cyw, cxw = coeffs.shape
    sy = resample_scales(cyw, cyw * 8)
    sx = resample_scales(cxw, cxw * 8)
    return coeffs / (sy[:, None] * sx[None, :])


def dc_from_lowest_frequencies(strategy: int, llf: np.ndarray) -> np.ndarray:
    """Inverse of lowest_frequencies_from_dc (enc: DCFromLowestFrequencies):
    llf (wide min x max) -> dc (cy, cx)."""
    cx, cy = acs.COVERED_X[strategy], acs.COVERED_Y[strategy]
    if cx == 1 and cy == 1:
        return llf.copy()
    cyw, cxw = llf.shape
    sy = resample_scales(cyw, cyw * 8)
    sx = resample_scales(cxw, cxw * 8)
    coeffs = llf * sy[:, None] * sx[None, :]
    return idct2d(coeffs, cy, cx)
