"""AC entropy context model: block contexts, nonzero contexts,
zero-density contexts.

Mirrors lib/jxl/ac_context.h and entropy_coder.cc (DecodeBlockCtxMap).
"""

from __future__ import annotations

import numpy as np

from ..base.status import JXLError
from .ac_strategy import NUM_ORDERS

NONZERO_BUCKETS = 37
ZERO_DENSITY_CONTEXT_COUNT = 458
ZERO_DENSITY_CONTEXT_LIMIT = 474

COEFF_FREQ_CONTEXT = np.array([
    0xBAD, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
    27, 27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30,
], dtype=np.int32)

COEFF_NUM_NONZERO_CONTEXT = np.array([
    0xBAD, 0, 31, 62, 62, 93, 93, 93, 93, 123, 123, 123, 123,
    152, 152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180,
    180, 180, 180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
], dtype=np.int32)

# Default ctx map (ac_context.h:92-96)
DEFAULT_CTX_MAP = [
    0, 1, 2, 2, 3, 3, 4, 5, 6, 6, 6, 6, 6,
    7, 8, 9, 9, 10, 11, 12, 13, 14, 14, 14, 14, 14,
    7, 8, 9, 9, 10, 11, 12, 13, 14, 14, 14, 14, 14,
]

QUANT_MAX = 256  # Quantizer::kQuantMax


class BlockCtxMap:
    """ac_context.h:85-148."""

    def __init__(self):
        self.dc_thresholds = [[], [], []]
        self.qf_thresholds = []
        self.ctx_map = list(DEFAULT_CTX_MAP)
        self.num_ctxs = max(self.ctx_map) + 1
        self.num_dc_ctxs = 1

    def num_ac_contexts(self) -> int:
        return self.num_ctxs * (NONZERO_BUCKETS + ZERO_DENSITY_CONTEXT_COUNT)


def decode_block_ctx_map(r) -> BlockCtxMap:
    """entropy_coder.cc:25-60."""
    b = BlockCtxMap()
    if r.read_bits(1):
        return b  # default
    from ..io.fields import u32_read, unpack_signed, U32Enc, Bits, BitsOffset
    from ..entropy.decode import decode_context_map

    dc_threshold_enc = U32Enc(Bits(4), BitsOffset(8, 16), BitsOffset(16, 272),
                              BitsOffset(32, 65808))
    qf_threshold_enc = U32Enc(Bits(2), BitsOffset(3, 4), BitsOffset(5, 12),
                              BitsOffset(8, 44))
    b.num_dc_ctxs = 1
    for j in range(3):
        n = r.read_bits(4)
        b.dc_thresholds[j] = [
            unpack_signed(u32_read(dc_threshold_enc, r)) for _ in range(n)]
        b.num_dc_ctxs *= n + 1
    nq = r.read_bits(4)
    b.qf_thresholds = [u32_read(qf_threshold_enc, r) + 1 for _ in range(nq)]
    if b.num_dc_ctxs * (nq + 1) > 64:
        raise JXLError("invalid block context map: too big")
    size = 3 * NUM_ORDERS * b.num_dc_ctxs * (nq + 1)
    b.ctx_map, b.num_ctxs = decode_context_map(size, r)
    if b.num_ctxs > 16:
        raise JXLError("too many block context map contexts")
    if b.num_dc_ctxs != 1:
        # per-block dc_idx derivation from quantized DC is not
        # implemented; every decode path would silently pick dc_idx=0
        # and mis-context the whole frame — fail loudly instead
        raise JXLError("dc-conditioned block context maps unsupported")
    return b


def encode_block_ctx_map(b: BlockCtxMap, w) -> None:
    """Inverse of decode_block_ctx_map (entropy_coder.cc:25-60)."""
    default = (not b.qf_thresholds and not any(b.dc_thresholds)
               and list(b.ctx_map) == DEFAULT_CTX_MAP)
    if default:
        w.write(1, 1)
        return
    from ..entropy.encode import encode_context_map
    from ..io.fields import BitsOffset, Bits, U32Enc, u32_write

    qf_threshold_enc = U32Enc(Bits(2), BitsOffset(3, 4), BitsOffset(5, 12),
                              BitsOffset(8, 44))
    w.write(1, 0)
    for j in range(3):
        w.write(4, len(b.dc_thresholds[j]))
        assert not b.dc_thresholds[j], "dc thresholds unsupported"
    w.write(4, len(b.qf_thresholds))
    for t in b.qf_thresholds:
        u32_write(qf_threshold_enc, t - 1, w)
    encode_context_map(b.ctx_map, b.num_ctxs, w)

