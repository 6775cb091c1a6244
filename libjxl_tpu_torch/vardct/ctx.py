"""AC entropy context model: block contexts, nonzero contexts,
zero-density contexts.

Mirrors lib/jxl/ac_context.h and entropy_coder.cc (DecodeBlockCtxMap).
"""

from __future__ import annotations

import numpy as np

from ..base.status import JXLError
from .ac_strategy import NUM_ORDERS, STRATEGY_ORDER

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


def zero_density_context(nonzeros_left: int, k: int, covered_blocks: int,
                         log2_covered_blocks: int, prev: int) -> int:
    """ac_context.h:62-82."""
    nonzeros_left = (nonzeros_left + covered_blocks - 1) >> log2_covered_blocks
    k >>= log2_covered_blocks
    return (int(COEFF_NUM_NONZERO_CONTEXT[nonzeros_left])
            + int(COEFF_FREQ_CONTEXT[k])) * 2 + prev


class BlockCtxMap:
    """ac_context.h:85-148."""

    def __init__(self):
        self.dc_thresholds = [[], [], []]
        self.qf_thresholds = []
        self.ctx_map = list(DEFAULT_CTX_MAP)
        self.num_ctxs = max(self.ctx_map) + 1
        self.num_dc_ctxs = 1

    def context(self, dc_idx: int, qf: int, ord_: int, c: int) -> int:
        qf_idx = sum(1 for t in self.qf_thresholds if qf > t)
        idx = (c ^ 1) if c < 2 else 2
        idx = idx * NUM_ORDERS + ord_
        idx = idx * (len(self.qf_thresholds) + 1) + qf_idx
        idx = idx * self.num_dc_ctxs + dc_idx
        return self.ctx_map[idx]

    def dc_index(self, q: list) -> np.ndarray:
        """Each block's DC context (compressed_dc.cc DequantDC): q[c] is
        channel c's quantized DC at the blocks' positions; channel c's
        bucket counts its thresholds below the value, and the buckets
        combine as (b0 * (n2 + 1) + b2) * (n1 + 1) + b1."""
        b = [np.zeros(np.shape(q[c]), dtype=np.int64) for c in range(3)]
        for c in range(3):
            for t in self.dc_thresholds[c]:
                b[c] += np.asarray(q[c]) > t
        n = [len(t) + 1 for t in self.dc_thresholds]
        return (b[0] * n[2] + b[2]) * n[1] + b[1]

    def nonzero_context(self, non_zeros: int, block_ctx: int) -> int:
        non_zeros = min(non_zeros, 64)
        ctx = non_zeros if non_zeros < 8 else 4 + non_zeros // 2
        return ctx * self.num_ctxs + block_ctx

    def zero_density_contexts_offset(self, block_ctx: int) -> int:
        return (self.num_ctxs * NONZERO_BUCKETS
                + ZERO_DENSITY_CONTEXT_COUNT * block_ctx)

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
    return b


def encode_block_ctx_map_default(w) -> None:
    w.write(1, 1)


def find_best_block_entropy_model(qf_field: np.ndarray,
                                  strategy_map: np.ndarray,
                                  origins: np.ndarray,
                                  distance: float) -> BlockCtxMap:
    """FindBestBlockEntropyModel (enc_heuristics.cc:1208): cluster
    (order class, quant bucket) cells by occupancy into block contexts,
    with a coarser chroma split. Returns the default map for small
    images."""
    b = BlockCtxMap()
    tot = int(qf_field.size)
    size_for_ctx_model = (1 << 10) * max(distance, 0.04)
    if tot < size_for_ctx_model:
        return b
    ords = np.asarray(STRATEGY_ORDER, np.int64)[strategy_map]
    qf = np.clip(qf_field.astype(np.int64) - 1, 0, 255)
    qf_counts = np.bincount(qf.reshape(-1), minlength=256)
    qf_ord = np.zeros((NUM_ORDERS, 256), dtype=np.int64)
    np.add.at(qf_ord, (ords.reshape(-1), qf.reshape(-1)), 1)

    size_for_qf_split = (1 << 13) * max(distance, 0.04)
    num_qf_segments = 1 if tot < size_for_qf_split else 2
    qft = []
    cumsum = 0
    nxt = 1
    last_cut = 256
    cut = tot * nxt // num_qf_segments
    for j in range(256):
        cumsum += int(qf_counts[j])
        if cumsum > cut:
            if j != 0:
                qft.append(j)
            last_cut = j
            while cumsum > cut:
                nxt += 1
                cut = tot * nxt // num_qf_segments
        elif nxt > len(qft) + 1:
            if j - 1 == last_cut and j != 0:
                qft.append(j)
    nseg = len(qft) + 1
    counts = np.zeros(NUM_ORDERS * nseg, dtype=np.int64)
    qft_pos = 0
    for j in range(256):
        if qft_pos < len(qft) and j == qft[qft_pos]:
            qft_pos += 1
        counts[qft_pos + np.arange(NUM_ORDERS) * nseg] += qf_ord[:, j]

    remap = list(range(nseg * NUM_ORDERS))
    clusters = list(remap)
    nb_clusters = max(2, min(9, tot // int(size_for_ctx_model) // 2))
    nb_clusters_chroma = max(1, min(5, tot // int(size_for_ctx_model) // 3))
    counts = counts.tolist()
    while len(clusters) > nb_clusters:
        clusters.sort(key=lambda a: -counts[a])
        counts[clusters[-2]] += counts[clusters[-1]]
        counts[clusters[-1]] = 0
        remap[clusters[-1]] = clusters[-2]
        clusters.pop()
    for i in range(len(remap)):
        while remap[remap[i]] != remap[i]:
            remap[i] = remap[remap[i]]
    remap_remap = [len(remap)] * len(remap)
    num = 0
    for i in range(len(remap)):
        if remap_remap[remap[i]] == len(remap):
            remap_remap[remap[i]] = num
            num += 1
        remap[i] = remap_remap[remap[i]]
    ctx_map = list(remap)
    for i in range(len(remap), len(remap) * 3):
        ctx_map.append(num + max(0, min(nb_clusters_chroma - 1,
                                        remap[i % len(remap)])))
    b.qf_thresholds = qft
    b.ctx_map = ctx_map
    b.num_ctxs = max(ctx_map) + 1
    b.num_dc_ctxs = 1
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


def predict_nzeros(nzeros_map: np.ndarray, c: int, by: int, bx: int) -> int:
    """PredictFromTopAndLeft (entropy_coder.h:25-35) over the per-channel
    nzeros map."""
    if bx == 0:
        return int(nzeros_map[c, by - 1, bx]) if by > 0 else 32
    if by == 0:
        return int(nzeros_map[c, by, bx - 1])
    return (int(nzeros_map[c, by - 1, bx]) + int(nzeros_map[c, by, bx - 1])
            + 1) // 2
