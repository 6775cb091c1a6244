"""jpegli decoder: float-precision JPEG decoding (lib/jpegli decode.cc).

Reuses the package's JPEG parser and batched float IDCT
(jpeg/data.parse_jpeg + jpeg/pixels.jpeg_to_pixels); adds the
jpegli-style smooth (triangular) chroma upsampling instead of libjpeg's
box replication.
"""

from __future__ import annotations

import numpy as np

from ..jpeg.data import parse_jpeg, ZIGZAG
from ..ops.dct import idct2d


def _upsample_tri(plane: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """Triangular (bilinear co-sited) 2x upsampling per axis, matching
    libjpeg's "fancy" upsampler / jpegli upsample.cc."""
    for _ in range(fx.bit_length() - 1):
        p = np.pad(plane, ((0, 0), (1, 1)), mode="edge")
        left = (3 * p[:, 1:-1] + p[:, :-2]) * 0.25
        right = (3 * p[:, 1:-1] + p[:, 2:]) * 0.25
        plane = np.empty((plane.shape[0], plane.shape[1] * 2),
                         dtype=plane.dtype)
        plane[:, 0::2] = left
        plane[:, 1::2] = right
    for _ in range(fy.bit_length() - 1):
        p = np.pad(plane, ((1, 1), (0, 0)), mode="edge")
        top = (3 * p[1:-1] + p[:-2]) * 0.25
        bottom = (3 * p[1:-1] + p[2:]) * 0.25
        plane = np.empty((plane.shape[0] * 2, plane.shape[1]),
                         dtype=plane.dtype)
        plane[0::2] = top
        plane[1::2] = bottom
    return plane


def decode_jpegli(data: bytes, bitdepth: int = 8) -> np.ndarray:
    """JPEG bytes -> (H, W, C) uint8 (bitdepth=8) or uint16 (bitdepth=16),
    C = 1 or 3.  The float pipeline quantizes only at the very end, so
    16-bit output carries the extra precision (djpegli --bitdepth).
    Raises JXLError on malformed input."""
    from ..base.status import JXLError

    if bitdepth not in (8, 16):
        raise JXLError("bitdepth must be 8 or 16")
    jd = parse_jpeg(data)
    try:
        return _render(jd, bitdepth)
    except JXLError:
        raise
    except (IndexError, KeyError, ValueError, OverflowError,
            MemoryError) as e:
        raise JXLError(f"malformed JPEG: {type(e).__name__}: {e}") from e


def _quantize(vals: np.ndarray, bitdepth: int) -> np.ndarray:
    if bitdepth == 16:
        # 0..255 float -> 0..65535 (jpegli's 16-bit output scale)
        return np.clip(np.round(vals * np.float32(65535.0 / 255.0)),
                       0, 65535).astype(np.uint16)
    return np.clip(np.round(vals), 0, 255).astype(np.uint8)


def _render(jd, bitdepth: int = 8) -> np.ndarray:
    hmax = max(c.h_samp for c in jd.components)
    vmax = max(c.v_samp for c in jd.components)
    planes = []
    for c in jd.components:
        q = np.asarray(jd.quant[c.quant_idx], dtype=np.float32)
        hb, wb = c.height_in_blocks, c.width_in_blocks
        coeffs = c.coeffs.astype(np.float32) * q[None, None, :]
        blocks = np.zeros((hb, wb, 64), dtype=np.float32)
        blocks[:, :, ZIGZAG] = coeffs
        blocks = blocks.reshape(hb, wb, 8, 8)
        pix = idct2d(np.swapaxes(blocks, -2, -1) * 0.125, 8, 8)
        plane = pix.transpose(0, 2, 1, 3).reshape(hb * 8, wb * 8) + 128.0
        fy = vmax // c.v_samp
        fx = hmax // c.h_samp
        if fy > 1 or fx > 1:
            plane = _upsample_tri(plane, fy, fx)
        planes.append(plane[:jd.height, :jd.width])
    if len(planes) == 1:
        return _quantize(planes[0], bitdepth)[..., None]
    y = planes[0].astype(np.float32)
    cb = planes[1].astype(np.float32) - np.float32(128.0)
    cr = planes[2].astype(np.float32) - np.float32(128.0)
    r = y + np.float32(1.402) * cr
    g = (y - np.float32(0.344136) * cb - np.float32(0.714136) * cr)
    b = y + np.float32(1.772) * cb
    rgb = np.stack([r, g, b], axis=-1)
    return _quantize(rgb, bitdepth)
