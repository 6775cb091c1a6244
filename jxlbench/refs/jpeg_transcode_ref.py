"""The plain decode of a losslessly recompressed JPEG, from the JPEG's own
quantized coefficients: the pixels a JPEG XL decoder gives for such a
file, computed by a route that shares nothing with the decoder under test.

Plain torch in float64; it imports nothing of the codec and no JAX.

    decode(components, width, height) -> u8 (height, width, 3)
    decode_parsed(jpeg) -> the same, from a parsed JPEG


components: the JPEG's components in frame order (Y, Cb, Cr), each a
Component: its quantized coefficients in zigzag order, int (rows of
blocks, blocks a row, 64), at least ceil(extent / 8) blocks each way; its
quantization table in zigzag order (64,); its sampling factors.

Steps, each with its source:

1. Dequantization, ITU-T T.81 A.3.4: a coefficient times its table
   entry. The AC coefficients first take JPEG XL's quantization bias
   (AdjustQuantBias, libjxl lib/jxl/quantizer-inl.h, with the default
   biases of lib/jxl/quantizer.h kDefaultQuantBias), each JPEG component
   on its JPEG XL channel (Y on 1, Cb on 0, Cr on 2): 0 stays 0, +-1
   becomes +-bias[channel], any other q becomes q - bias[3] / q. This is
   the one step read from the decoders' behaviour rather than from a
   specification: libjxl 0.7's decode of transcoded JPEGs matches it to
   one u8 step, and matches the same decode without the bias, or with
   the bias on the DC too, far worse (PERF.md's findings on the
   transcode cell; tests/test_torch_jpeg_transcode.py holds this
   reference to libjxl where libjxl is installed).
2. The DC step as JPEG XL signals it: a transcode writes the DC
   quantization step Q[0] / (8 * 255) as a float16 of 128 times it
   (libjxl lib/jxl/quant_weights.cc DequantMatrices::EncodeDC), so the
   decoder's DC is q * f16(128 * Q[0] / 2040) / 128 * 2040 in pixel
   units. The reference takes that rounded step (dc_rounded=True, the
   default); the plain T.81 step Q[0] differs from it by up to 2^-12 of
   the DC.
3. The inverse DCT of T.81 A.3.3: the orthonormal 8x8 DCT-III; then the
   level shift, +128 (A.3.1).
4. Chroma upsampling, libjxl lib/jxl/render_pipeline/
   stage_chroma_upsampling.cc: for each axis on which a component is
   subsampled (horizontal first), output 2x = 0.75 in[x] + 0.25 in[x-1]
   and 2x + 1 = 0.75 in[x] + 0.25 in[x+1], the neighbour outside the
   component's extent (T.81 A.1.1: ceil(X * H / Hmax) by ceil(Y * V /
   Vmax)) replaced by the edge sample.
5. Colour, JFIF 1.02 (BT.601 full range): R = Y + 1.402 Cr,
   G = Y - 0.344136 Cb - 0.714136 Cr, B = Y + 1.772 Cb, with Cb and Cr
   less 128; rounded to the nearest integer and clamped to [0, 255].

lower, when given, is applied to each step's output (the bfloat16
control rounds there).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# T.81 Figure A.6: the zigzag position of each natural (row-major) index
ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
          26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
          56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
          45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
# libjxl kDefaultQuantBias: per JPEG XL channel (0, 1, 2), then the
# numerator of the general case
QUANT_BIAS = (1 - 0.05465007330715401, 1 - 0.07005449891748593,
              1 - 0.049935103337343655, 0.145)
# the JPEG XL channel of each JPEG component (Y, Cb, Cr)
JXL_CHANNEL = (1, 0, 2)


class Component(NamedTuple):
    coeffs: np.ndarray      # int (rows of blocks, blocks a row, 64), zigzag
    qtable: np.ndarray      # (64,), zigzag
    h_samp: int = 1
    v_samp: int = 1


def _idct_matrix() -> torch.Tensor:
    """M[x, u] = C(u) / 2 * cos((2x + 1) u pi / 16): pixels = M F M^T."""
    m = torch.zeros(8, 8, dtype=torch.float64)
    for x in range(8):
        for u in range(8):
            cu = 1 / math.sqrt(2) if u == 0 else 1.0
            m[x, u] = cu / 2 * math.cos((2 * x + 1) * u * math.pi / 16)
    return m


def _f16_step(q0: float) -> float:
    """The DC step JPEG XL signals for table entry q0, in pixel units."""
    return float(np.float16(q0 / 2040.0 * 128.0)) / 128.0 * 2040.0


def _dequantize(comp: Component, channel: int, dc_rounded: bool,
                device) -> torch.Tensor:
    """Dequantized coefficients, natural order: (rows, cols, 8, 8)."""
    q = torch.as_tensor(np.asarray(comp.coeffs), dtype=torch.float64,
                        device=device)
    table = torch.as_tensor(np.asarray(comp.qtable, dtype=np.float64),
                            device=device)
    ac = q[..., 1:]
    safe = torch.where(ac == 0, torch.ones_like(ac), ac)
    biased = torch.where(
        ac == 0, torch.zeros_like(ac),
        torch.where(ac.abs() == 1, torch.sign(ac) * QUANT_BIAS[channel],
                    ac - QUANT_BIAS[3] / safe))
    step0 = _f16_step(float(table[0])) if dc_rounded else float(table[0])
    zz = torch.cat([q[..., :1] * step0, biased * table[1:]], dim=-1)
    nat = torch.empty_like(zz)
    nat[..., list(ZIGZAG)] = zz
    return nat.reshape(*nat.shape[:-1], 8, 8)


def _upsample(plane: torch.Tensor, extent: int, dim: int) -> torch.Tensor:
    """Twice the samples along dim (0 rows, 1 columns) by the 0.75 / 0.25
    taps, from the first `extent` samples, edges replicated."""
    x = plane.narrow(dim, 0, extent)
    idx = torch.arange(extent, device=plane.device)
    prev = x.index_select(dim, (idx - 1).clamp(min=0))
    nxt = x.index_select(dim, (idx + 1).clamp(max=extent - 1))
    even = 0.75 * x + 0.25 * prev
    odd = 0.75 * x + 0.25 * nxt
    out = torch.stack([even, odd], dim=dim + 1)
    shape = list(x.shape)
    shape[dim] *= 2
    return out.reshape(shape)


def decode(components, width: int, height: int, *, dc_rounded=True,
           lower=None, device="cpu") -> np.ndarray:
    """The u8 (height, width, 3) image of a three-component JPEG's
    coefficients (a one-component JPEG gives its grey in all three)."""
    keep = (lambda t: t) if lower is None else lower
    hmax = max(c.h_samp for c in components)
    vmax = max(c.v_samp for c in components)
    m = _idct_matrix().to(device)
    planes = []
    for i, comp in enumerate(components):
        co = keep(_dequantize(comp, JXL_CHANNEL[i], dc_rounded, device))
        pix = keep(torch.einsum("xu,rcuv,yv->rcxy", m, co, m) + 128.0)
        rows, cols = pix.shape[:2]
        plane = pix.permute(0, 2, 1, 3).reshape(rows * 8, cols * 8)
        ext_x = -(-width * comp.h_samp // hmax)
        ext_y = -(-height * comp.v_samp // vmax)
        plane = plane[:ext_y, :ext_x]
        for f, dim, ext in ((hmax // comp.h_samp, 1, ext_x),
                            (vmax // comp.v_samp, 0, ext_y)):
            if f == 2:
                plane = keep(_upsample(plane, ext, dim))
            elif f != 1:
                raise ValueError(f"sampling ratio {f} is not 1 or 2")
        planes.append(plane[:height, :width])
    if len(planes) == 1:  # grey: no chroma
        planes += [torch.full_like(planes[0], 128.0)] * 2
    y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
    rgb = keep(torch.stack([y + 1.402 * cr,
                            y - 0.344136 * cb - 0.714136 * cr,
                            y + 1.772 * cb], dim=-1))
    return torch.round(rgb).clamp(0, 255).to(torch.uint8).cpu().numpy()


def components_of(jpeg) -> list:
    """The Components of a parsed JPEG: an object with .components (each
    with .coeffs, zigzag, .quant_idx, .h_samp, .v_samp) and .quant (table
    index -> zigzag table), as the codec's JPEG parser gives it."""
    return [Component(c.coeffs, np.asarray(jpeg.quant[c.quant_idx]),
                      c.h_samp, c.v_samp) for c in jpeg.components]


def decode_parsed(jpeg, **kw) -> np.ndarray:
    """decode() of a parsed JPEG (components_of), at its own size."""
    return decode(components_of(jpeg), jpeg.width, jpeg.height, **kw)
