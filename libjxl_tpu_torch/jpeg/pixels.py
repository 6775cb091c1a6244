"""JPEG coefficients -> pixels (dequant + IDCT + chroma upsample + YCbCr).

The decode path of extras/dec/jpg.cc reimagined: all blocks of a component
IDCT in one batched matmul (ops/dct), chroma upsampled by replication
(box) for 4:2:0/4:2:2.
"""

from __future__ import annotations

import numpy as np

from ..ops.dct import idct2d
from .data import JPEGData, ZIGZAG


def jpeg_to_pixels(jd: JPEGData) -> np.ndarray:
    """-> (H, W, C) uint8 (C = 1 or 3)."""
    hmax = max(c.h_samp for c in jd.components)
    vmax = max(c.v_samp for c in jd.components)
    planes = []
    for c in jd.components:
        q = np.asarray(jd.quant[c.quant_idx], dtype=np.float64)
        hb, wb = c.height_in_blocks, c.width_in_blocks
        coeffs = c.coeffs.astype(np.float64) * q[None, None, :]
        # de-zigzag into 8x8 natural order
        blocks = np.zeros((hb, wb, 64))
        blocks[:, :, ZIGZAG] = coeffs
        blocks = blocks.reshape(hb, wb, 8, 8)
        # JPEG IDCT: f = (1/4) sum c(u)c(v) F cos cos with c(0)=1/sqrt(2),
        # c(u>0)=1. Our idct2d uses c'(0)=1, c'(u>0)=sqrt(2) = sqrt(2)*c(u),
        # so f = (1/8) sum c'(u)c'(v) F cos cos -> scale coefficients by 1/8.
        # idct2d consumes the transposed ([hfreq][vfreq]) layout for square
        # blocks; JPEG blocks are natural, so swap axes first
        pix = idct2d(np.swapaxes(blocks, -2, -1) * 0.125, 8, 8)
        plane = pix.transpose(0, 2, 1, 3).reshape(hb * 8, wb * 8) + 128.0
        # upsample to full resolution
        fy = vmax // c.v_samp
        fx = hmax // c.h_samp
        if fy > 1 or fx > 1:
            plane = np.repeat(np.repeat(plane, fy, axis=0), fx, axis=1)
        planes.append(plane[:jd.height, :jd.width])
    if len(planes) == 1:
        return np.clip(np.round(planes[0]), 0, 255).astype(np.uint8)[..., None]
    y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)
