"""The yardstick of the roofline metrics: the work a kernel must do, counted
from its inputs' shapes, and the least time an NVIDIA H100 needs for it.

The arithmetic is frozen here, copied from chip_smoke.py (`bound`,
`tail_work`, the `K*_OPS` counts) and from the port's EPF geometry
(ops/pipeline.EPF_CHAINS, EPF_GEOMETRY), so that a later change to the
program cannot move the yardstick it is measured against.

Counting rules. Each input byte is read once and each output byte written
once. Operations are fp32 (or integer) operations, counted from the plain
twins' arithmetic. The bound is the larger of bytes at the memory rate and
operations at the fp32 rate. Where two kernels form one layer (the render:
dequant_idct8 then render_tail), the layer's bytes leave out the image the
first hands to the second, so that the bound holds for any implementation
of the layer, fused or not.
"""

from __future__ import annotations

# An H100 SXM's peaks (NVIDIA's data sheet, at the full 700 W): device
# memory, and fp32 outside the tensor cores, the rate integer operations
# are counted at too
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12

# Operations a unit of work (chip_smoke.py): K1 a coefficient
# (AdjustQuantBias and dequant 6, two 8-tap IDCT passes 32); the render
# tail a pixel: Gaborish (3 channels x 9 multiply-adds), an EPF pass a
# neighbour (cross-difference 11, weight 3, accumulation 7, plus the SAD
# pattern's taps) and a pass a pixel (division and skip 4), the colour
# epilogue (XYB cubes 14, 3x3 matrix 15, sRGB curve and u8 rounding 11);
# K3 a step (refill 6, contexts 25, alias entry and state 20, hybrid uint
# 20, bookkeeping 15, chain advance 10, tape 4).
K1_OPS = 38
GAB_OPS = 54
K2_OPS_NEIGHBOUR, K2_OPS_PIXEL = 21, 4
COLOUR_OPS = 40
K3_OPS_PER_STEP = 100

# EPF passes by epf_iters, and each pass's (neighbour count, SAD taps);
# a pass without a SAD pattern reads one tap
EPF_CHAINS = {0: (), 1: (1,), 2: (1, 2), 3: (0, 1, 2)}
EPF_GEOMETRY = {0: (12, 5), 1: (4, 5), 2: (4, 1)}


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the card needs for `nbytes` and `ops`."""
    return max(nbytes / HBM_BYTES_S, ops / FP32_OPS_S)


def tail_ops_per_pixel(epf_iters: int, gab: bool) -> int:
    """render_tail's operations a pixel with the u8 colour write."""
    ops = GAB_OPS if gab else 0
    for p in EPF_CHAINS[epf_iters]:
        neighbours, taps = EPF_GEOMETRY[p]
        ops += neighbours * (K2_OPS_NEIGHBOUR + taps) + K2_OPS_PIXEL
    return ops + COLOUR_OPS


def render_work(height: int, width: int, epf_iters: int,
                gab: bool) -> tuple[int, int]:
    """(bytes, operations) of one frame's render: dequant_idct8 over every
    coefficient of the block-padded frame, then render_tail to sRGB u8.

    Bytes: the quantized coefficients (2 bytes each: they fit int16), the
    quant field (4 bytes a block), the DC (3 x 4 bytes a block), the
    chroma-from-luma maps (2 x 4 bytes a 64 x 64 tile), the EPF sigma (4
    bytes a block) when a pass runs, the u8 output (3 bytes a pixel)."""
    h8, w8 = -(-height // 8), -(-width // 8)
    pixels = h8 * w8 * 64
    blocks = h8 * w8
    tiles = -(-height // 64) * -(-width // 64)
    nbytes = (2 * 3 * pixels + 4 * blocks + 12 * blocks + 8 * tiles
              + (4 * blocks if epf_iters else 0) + 3 * pixels)
    ops = K1_OPS * 3 * pixels + tail_ops_per_pixel(epf_iters, gab) * pixels
    return nbytes, ops


def ans_work(tokens: int, stream_bytes: int) -> tuple[int, int]:
    """(bytes, operations) of ans_decode on streams that hold `tokens` AC
    symbols in `stream_bytes` bytes: the streams read once, a 4-byte tape
    word written a symbol; K3_OPS_PER_STEP a symbol."""
    return stream_bytes + 4 * tokens, K3_OPS_PER_STEP * tokens
