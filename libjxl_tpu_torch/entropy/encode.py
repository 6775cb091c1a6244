"""Entropy encoding: histogram building/serialization + rANS token writing.

Mirrors BuildAndEncodeHistograms / WriteTokens / EncodeContextMap
(enc_ans.cc, enc_context_map.cc). Tokens are (context, value) pairs; per
stream the writer emits symbols in *reverse* order through the rANS coder
(enc_ans.h:49-71), then reverses the produced bit groups.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..base.status import JXLError
from ..io.bits import BitWriter
from .alias import build_reverse_map, init_alias_table
from .cluster import cluster_histograms
from .decode import LZ77Params
from .histogram import (
    compute_best_method,
    create_flat_histogram,
    encode_counts,
    encode_flat_histogram,
    normalize_counts,
    store_varlen_uint16,
)
from .hybrid_uint import DEFAULT_UINT_CONFIG, HybridUintConfig
from .params import ANS_LOG_TAB_SIZE, ANS_SIGNATURE, ANS_TAB_SIZE, CLUSTERS_LIMIT


@dataclass(frozen=True)
class Token:
    context: int
    value: int
    is_lz77_length: bool = False


class TokenArray:
    """Columnar token block: (context, value) arrays. Token lists may mix
    Token objects and TokenArray blocks; bulk producers (the vectorized
    modular tokenizer) emit these so histogram building and stream
    writing stay vectorized end to end."""

    __slots__ = ("ctx", "value", "is_lz77")

    def __init__(self, ctx, value, is_lz77=None):
        # uint32 passes through unconverted: the bulk AC tokenizer emits
        # u32 and both tokenization paths accept it (the C fast path
        # reads either width), sparing an int64 copy of every stream
        v = np.asarray(value)
        if v.dtype not in (np.uint32, np.int64):
            v = v.astype(np.int64)
        self.value = np.ascontiguousarray(v)
        c = np.asarray(ctx)
        if c.ndim == 0:
            c = np.full(len(self.value), int(c), dtype=np.int32)
        self.ctx = np.ascontiguousarray(c, dtype=np.int32)
        self.is_lz77 = is_lz77  # bool array or None

    def __len__(self):
        return len(self.value)


def flatten_tokens(tokens):
    """Token|TokenArray list -> (ctx i32[n], value i64[n], lz77 bool[n]
    or None)."""
    ctxs, vals, lzs = [], [], []
    any_lz = False
    pc, pv, pl = [], [], []  # pending scalar Tokens, batched

    def flush():
        if pc:
            ctxs.append(np.asarray(pc, dtype=np.int32))
            vals.append(np.asarray(pv, dtype=np.int64))
            lzs.append(np.asarray(pl, dtype=bool))
            pc.clear()
            pv.clear()
            pl.clear()

    for item in tokens:
        if isinstance(item, TokenArray):
            flush()
            ctxs.append(item.ctx)
            vals.append(item.value)
            if item.is_lz77 is not None:
                lzs.append(np.asarray(item.is_lz77, dtype=bool))
                any_lz = any_lz or bool(lzs[-1].any())
            else:
                lzs.append(np.zeros(len(item), dtype=bool))
        else:
            pc.append(item.context)
            pv.append(item.value)
            pl.append(item.is_lz77_length)
            any_lz = any_lz or item.is_lz77_length
    flush()
    if not ctxs:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.int32), z, None
    if len(ctxs) == 1:
        # single bulk block: no concatenate copy
        return ctxs[0], vals[0], (lzs[0] if any_lz else None)
    ctx = np.concatenate(ctxs)
    val = np.concatenate(vals)
    if val.dtype != np.int64:
        val = val.astype(np.int64)
    lz = np.concatenate(lzs) if any_lz else None
    return ctx, val, lz


class EntropyEncodingData:
    """Per-cluster encoding info (enc_ans.h:75-96 analog)."""

    def __init__(self):
        self.use_prefix_code = False
        self.log_alpha_size = 7
        self.uint_config: list = []
        self.lz77 = LZ77Params()
        # transformed token lists when LZ77 was applied (same order as the
        # tokens_list passed to build_and_encode_histograms), else None
        self.lz77_tokens = None
        # per-stream (ctx, tok, nbits, bits) cached by the histogram pass;
        # pass codes.tokenized[i] to write_tokens to skip re-tokenizing
        self.tokenized = None
        # per cluster: (freqs int32[alpha], reverse_map int32[alpha, maxfreq])
        self.encoding_info: list = []


class _MtfEncoder:
    def __init__(self):
        self.mtf = list(range(256))

    def encode(self, value: int) -> int:
        idx = self.mtf.index(value)
        del self.mtf[idx]
        self.mtf.insert(0, value)
        return idx


def _tokenize_arrays(ctx, val, lz, uint_config, lz77):
    """-> (tok u32, nbits u8, bits u32) for flattened token arrays."""
    tok, nbits, bits = uint_config.encode_array(val)
    if lz is not None and lz77 is not None and lz.any():
        lt, ln, lb = lz77.length_uint_config.encode_array(
            val[lz].astype(np.uint64))
        tok = tok.astype(np.uint32)
        tok[lz] = lt + lz77.min_symbol
        nbits = nbits.copy()
        nbits[lz] = ln
        bits = bits.copy()
        bits[lz] = lb
    return tok, nbits, bits


# tokens are < 256 for every config in use (log_alpha_size caps at 8:
# hybrid-uint tokens reach ~131 for 64-bit values; LZ77 length tokens
# start at min_symbol=224)
_MAX_TOK = 256


def _estimate_token_cost(tokens_list, num_contexts, uint_config, lz77=None,
                         collect=None):
    """collect: optional list; receives (ctx, tok, nbits, bits) per stream
    so the write pass can skip re-tokenizing."""
    from ..native_ext import (get_lib, hybrid_tokenize_mixed_native,
                              hybrid_tokenize_native)

    n_bins = num_contexts * _MAX_TOK
    lib = get_lib()
    use_native = (lib is not None and hasattr(lib, "hybrid_tokenize")
                  and (lz77 is None
                       or hasattr(lib, "hybrid_tokenize_mixed")))
    counts_c = np.zeros(n_bins, dtype=np.uint32) if use_native else None
    flats = []
    for tokens in tokens_list:
        ctx, val, lz = flatten_tokens(tokens)
        if len(val) == 0:
            if collect is not None:
                collect.append(None)
            continue
        if use_native and lz is None and len(val) >= 32:
            # one C pass: hybrid-uint split + (ctx, tok) histogram
            res = hybrid_tokenize_native(
                lib, ctx, val, uint_config.split_exponent,
                uint_config.msb_in_token, uint_config.lsb_in_token,
                counts_c, _MAX_TOK)
            if res is not None:
                if collect is not None:
                    collect.append((ctx,) + res)
                continue
        if use_native and lz is not None and lz77 is not None \
                and len(val) >= 32 and (val >= 0).all():
            # mixed literal/length stream in one C pass
            res = hybrid_tokenize_mixed_native(
                lib, ctx, val, lz, uint_config,
                lz77.length_uint_config, lz77.min_symbol,
                counts_c, _MAX_TOK)
            if res is not None:
                if collect is not None:
                    collect.append((ctx,) + res)
                continue
        tok, nbits, bits = _tokenize_arrays(ctx, val, lz, uint_config, lz77)
        if collect is not None:
            collect.append((ctx, tok, nbits, bits))
        flats.append(ctx.astype(np.int64) * _MAX_TOK + tok)
    if flats:
        counts = np.bincount(np.concatenate(flats) if len(flats) > 1
                             else flats[0], minlength=n_bins)
        if counts_c is not None:
            counts = counts + counts_c
    elif counts_c is not None:
        counts = counts_c.astype(np.int64)
    else:
        counts = np.zeros(n_bins, dtype=np.int64)
    grid = counts.reshape(num_contexts, _MAX_TOK)
    histograms = []
    for row in grid:
        nz = np.flatnonzero(row)
        end = int(nz[-1]) + 1 if len(nz) else 1
        histograms.append([int(x) for x in row[:end]])
    return histograms


def _apply_lz77_rle(tokens_list, num_contexts, lz77, uint_config,
                    distance_symbol=0, cost_free=False):
    """ApplyLZ77_RLE (enc_ans.cc:931-1001), vectorized: replace runs of
    repeated token values with (length, distance=1) pairs. Returns
    (new_lists, accepted). The distance token goes to the appended
    context `num_contexts`.
    distance_symbol: 0 when the decoding reader has no distance
    multiplier; 1 (kSpecialDistances[1] = {1,0}) when it does, as in
    modular streams (enc_ans.cc:958-963).
    cost_free: one-pass mode (fast-lossless tier, enc_fast_lossless.cc
    spirit): no histogram cost model; accept zero runs and long runs
    outright and skip the global acceptance threshold."""
    cost_mat = None
    if not cost_free:
        # symbol cost estimator: -log2(p) from the original token histograms
        histograms = _estimate_token_cost(tokens_list, num_contexts,
                                          uint_config)
        cost_mat = np.full((num_contexts, _MAX_TOK), 14.0)
        for c, h in enumerate(histograms):
            arr = np.asarray(h, dtype=np.float64)
            total = arr.sum()
            if total == 0:
                continue
            nz = arr > 0
            row = cost_mat[c, :len(arr)]
            row[nz] = np.log2(total) - np.log2(arr[nz])

    bit_decrease = 0.0
    total_symbols = 0
    out_lists = []
    min_length = lz77.min_length
    for tokens in tokens_list:
        ctx, val, _ = flatten_tokens(tokens)
        n = len(val)
        total_symbols += n
        if n == 0:
            out_lists.append(tokens)
            continue
        if cost_free:
            cum = None
        else:
            tok, nbits, _ = uint_config.encode_array(val)
            costs = cost_mat[ctx, tok] + nbits
            cum = np.concatenate(([0.0], np.cumsum(costs)))
        # copyable[j]: token j repeats token j-1's value (j >= 1)
        copyable = np.zeros(n, dtype=bool)
        copyable[1:] = val[1:] == val[:-1]
        edges = np.diff(copyable.astype(np.int8))
        starts = np.flatnonzero(edges == 1) + 1
        ends = np.flatnonzero(edges == -1) + 1
        if copyable[0]:
            starts = np.insert(starts, 0, 0)
        if copyable[-1]:
            ends = np.append(ends, n)
        if len(starts) == 0:
            out_lists.append(tokens)
            continue
        lens = ends - starts
        lz_len = lens - min_length
        if cost_free:
            # runs of zeros pay off at any length; other values only when
            # clearly long enough to beat their (unknown) literal cost
            accept = (lens >= min_length) \
                & ((val[starts] == 0) | (lens >= 16))
        else:
            run_cost = cum[ends] - cum[starts]
            lz_cost = np.where(
                lens >= min_length,
                np.maximum(1, np.ceil(
                    np.log2(np.maximum(lz_len, 0) + 2))) + 1,
                0.0)
            accept = (lens >= min_length) & (run_cost > lz_cost)
        starts2, ends2 = starts[accept], ends[accept]
        lz_len2 = lz_len[accept]
        if len(starts2) == 0:
            out_lists.append(tokens)
            continue
        if cost_free:
            bit_decrease += float(lens[accept].sum())
        else:
            bit_decrease += float((run_cost[accept] - lz_cost[accept]).sum())
        # kept tokens = everything outside accepted runs
        d = np.zeros(n + 1, dtype=np.int32)
        d[starts2] += 1
        d[ends2] -= 1
        keep = np.cumsum(d[:n]) == 0
        pos_kept = np.flatnonzero(keep)
        k = len(starts2)
        # stable interleave: kept tokens, then per run (length, distance)
        keys = np.concatenate([pos_kept * 4, starts2 * 4 + 1,
                               starts2 * 4 + 2])
        order = np.argsort(keys, kind="stable")
        out_ctx = np.concatenate([
            ctx[pos_kept], ctx[starts2],
            np.full(k, num_contexts, dtype=np.int32)])[order]
        out_val = np.concatenate([
            val[pos_kept], lz_len2.astype(np.int64),
            np.full(k, distance_symbol, dtype=np.int64)])[order]
        out_lz = np.concatenate([
            np.zeros(len(pos_kept), dtype=bool), np.ones(k, dtype=bool),
            np.zeros(k, dtype=bool)])[order]
        out_lists.append([TokenArray(out_ctx, out_val, out_lz)])
    accepted = bit_decrease > total_symbols * 0.2 + 16
    return out_lists, accepted


def _apply_lz77_chain(tokens_list, num_contexts, lz77, uint_config,
                      widths=None):
    """ApplyLZ77_LZ77 (enc_ans.cc:1273-1370): hash-chain match search with
    greedy-lazy emission, run in C (native/lz77_match.c). Returns
    (new_lists, accepted). widths: per-stream decoder distance
    multiplier (0 = none)."""
    from ..native_ext import get_lib, _ptr
    import ctypes

    lib = get_lib()
    if lib is None or not hasattr(lib, "lz77_find_matches"):
        return tokens_list, False
    lib.lz77_find_matches.restype = ctypes.c_int
    from .decode import NUM_SPECIAL_DISTANCES, special_distance

    histograms = _estimate_token_cost(tokens_list, num_contexts, uint_config)
    cost_mat = np.full((num_contexts, _MAX_TOK), 14.0)
    for c, h in enumerate(histograms):
        arr = np.asarray(h, dtype=np.float64)
        total = arr.sum()
        if total == 0:
            continue
        nz = arr > 0
        row = cost_mat[c, :len(arr)]
        row[nz] = np.log2(total) - np.log2(arr[nz])

    bit_decrease = 0.0
    total_symbols = 0
    out_lists = []
    min_length = lz77.min_length
    lut_cache = {}
    for si, tokens in enumerate(tokens_list):
        mult = widths[si] if widths else 0
        ctx, val, _ = flatten_tokens(tokens)
        n = len(val)
        total_symbols += n
        if n < 16:
            out_lists.append(tokens)
            continue
        tok, nbits, _ = uint_config.encode_array(val)
        costs = cost_mat[ctx, tok] + nbits
        cum = np.concatenate(([0.0], np.cumsum(costs))).astype(np.float32)
        if mult not in lut_cache:
            if mult:
                sds = [special_distance(i, mult)
                       for i in range(NUM_SPECIAL_DISTANCES)]
                max_sd = max(sds)
                lut = np.full(max_sd + 1, -1, dtype=np.int32)
                for i in reversed(range(NUM_SPECIAL_DISTANCES)):
                    lut[sds[i]] = i
                lut_cache[mult] = (lut, max_sd, NUM_SPECIAL_DISTANCES)
            else:
                lut_cache[mult] = (np.full(1, -1, dtype=np.int32), 0, 0)
        lut, max_sd, n_special = lut_cache[mult]
        vals32 = np.ascontiguousarray(val, dtype=np.uint32)
        m_pos = np.zeros(n, dtype=np.uint32)
        m_len = np.zeros(n, dtype=np.uint32)
        m_dist = np.zeros(n, dtype=np.uint32)
        bd = ctypes.c_float(0)
        nm = lib.lz77_find_matches(
            _ptr(vals32, ctypes.c_uint32), ctypes.c_uint32(n),
            _ptr(cum, ctypes.c_float), ctypes.c_float(10.0),
            ctypes.c_uint32(min_length),
            _ptr(lut, ctypes.c_int32), ctypes.c_int(max_sd),
            ctypes.c_int(n_special),
            _ptr(m_pos, ctypes.c_uint32), _ptr(m_len, ctypes.c_uint32),
            _ptr(m_dist, ctypes.c_uint32), ctypes.byref(bd))
        if nm <= 0:
            out_lists.append(tokens)
            continue
        bit_decrease += bd.value
        starts = m_pos[:nm].astype(np.int64)
        lens = m_len[:nm].astype(np.int64)
        dists = m_dist[:nm].astype(np.int64)
        ends = starts + lens
        # kept literals = outside accepted matches
        d = np.zeros(n + 1, dtype=np.int32)
        d[starts] += 1
        d[np.minimum(ends, n)] -= 1
        keep = np.cumsum(d[:n]) == 0
        pos_kept = np.flatnonzero(keep)
        k = nm
        keys = np.concatenate([pos_kept * 4, starts * 4 + 1,
                               starts * 4 + 2])
        order = np.argsort(keys, kind="stable")
        out_ctx = np.concatenate([
            ctx[pos_kept], ctx[starts],
            np.full(k, num_contexts, dtype=np.int32)])[order]
        out_val = np.concatenate([
            val[pos_kept], lens - min_length, dists])[order]
        out_lz = np.concatenate([
            np.zeros(len(pos_kept), dtype=bool), np.ones(k, dtype=bool),
            np.zeros(k, dtype=bool)])[order]
        out_lists.append([TokenArray(out_ctx, out_val, out_lz)])
    accepted = bit_decrease > total_symbols * 0.2 + 16
    return out_lists, accepted


def _apply_lz77_optimal(tokens_list, num_contexts, lz77, uint_config,
                        widths=None):
    """ApplyLZ77_Optimal (enc_ans.cc:1376-1470): run the greedy-lazy
    matcher first; if it pays off, re-derive symbol costs from the greedy
    output's histograms and solve a shortest-path DP over all matches per
    position (native/lz77_match.c lz77_optimal)."""
    import ctypes

    from ..native_ext import _ptr, get_lib

    greedy_lists, accepted = _apply_lz77_chain(tokens_list, num_contexts,
                                               lz77, uint_config, widths)
    if not accepted:
        return tokens_list, False
    lib = get_lib()
    if lib is None or not hasattr(lib, "lz77_optimal"):
        return greedy_lists, True
    lib.lz77_optimal.restype = ctypes.c_int
    from .decode import NUM_SPECIAL_DISTANCES, special_distance

    # cost model from the greedy result (SymbolCostEstimator analog):
    # literal+length contexts 0..num_contexts-1, distances at num_contexts
    histograms = _estimate_token_cost(greedy_lists, num_contexts + 1,
                                      uint_config, lz77)
    cost_mat = np.full((num_contexts + 1, _MAX_TOK), 14.0)
    for c, h in enumerate(histograms):
        arr = np.asarray(h, dtype=np.float64)
        total = arr.sum()
        if total == 0:
            continue
        nz = arr > 0
        row = cost_mat[c, :len(arr)]
        row[nz] = np.log2(total) - np.log2(arr[nz])
    lcfg = lz77.length_uint_config
    len_tok_cost = np.ascontiguousarray(
        cost_mat[:num_contexts, lz77.min_symbol:lz77.min_symbol + 32],
        dtype=np.float32)
    dist_tok_cost = np.ascontiguousarray(cost_mat[num_contexts],
                                         dtype=np.float32)

    min_length = lz77.min_length
    out_lists = []
    lut_cache = {}
    for si, tokens in enumerate(tokens_list):
        mult = widths[si] if widths else 0
        ctx, val, _ = flatten_tokens(tokens)
        n = len(val)
        if n < 16:
            out_lists.append(tokens)
            continue
        tok, nbits, _ = uint_config.encode_array(val)
        costs = cost_mat[ctx, tok] + nbits
        cum = np.concatenate(([0.0], np.cumsum(costs))).astype(np.float32)
        if mult not in lut_cache:
            if mult:
                sds = [special_distance(i, mult)
                       for i in range(NUM_SPECIAL_DISTANCES)]
                max_sd = max(sds)
                lut = np.full(max_sd + 1, -1, dtype=np.int32)
                for i in reversed(range(NUM_SPECIAL_DISTANCES)):
                    lut[sds[i]] = i
                lut_cache[mult] = (lut, max_sd, NUM_SPECIAL_DISTANCES)
            else:
                lut_cache[mult] = (np.full(1, -1, dtype=np.int32), 0, 0)
        lut, max_sd, n_special = lut_cache[mult]
        vals32 = np.ascontiguousarray(val, dtype=np.uint32)
        ctx32 = np.ascontiguousarray(ctx, dtype=np.int32)
        m_pos = np.zeros(n, dtype=np.uint32)
        m_len = np.zeros(n, dtype=np.uint32)
        m_dist = np.zeros(n, dtype=np.uint32)
        bits = ctypes.c_float(0)
        nm = lib.lz77_optimal(
            _ptr(vals32, ctypes.c_uint32), _ptr(ctx32, ctypes.c_int32),
            ctypes.c_uint32(n), _ptr(cum, ctypes.c_float),
            _ptr(len_tok_cost, ctypes.c_float), ctypes.c_int(num_contexts),
            ctypes.c_int(lcfg.split_exponent), ctypes.c_int(lcfg.msb_in_token),
            ctypes.c_int(lcfg.lsb_in_token),
            _ptr(dist_tok_cost, ctypes.c_float), ctypes.c_int(_MAX_TOK),
            ctypes.c_int(uint_config.split_exponent),
            ctypes.c_int(uint_config.msb_in_token),
            ctypes.c_int(uint_config.lsb_in_token),
            ctypes.c_uint32(min_length),
            _ptr(lut, ctypes.c_int32), ctypes.c_int(max_sd),
            ctypes.c_int(n_special),
            _ptr(m_pos, ctypes.c_uint32), _ptr(m_len, ctypes.c_uint32),
            _ptr(m_dist, ctypes.c_uint32), ctypes.byref(bits))
        if nm <= 0:
            out_lists.append(greedy_lists[si])
            continue
        starts = m_pos[:nm].astype(np.int64)
        lens = m_len[:nm].astype(np.int64)
        dists = m_dist[:nm].astype(np.int64)
        ends = starts + lens
        d = np.zeros(n + 1, dtype=np.int32)
        d[starts] += 1
        d[np.minimum(ends, n)] -= 1
        keep = np.cumsum(d[:n]) == 0
        pos_kept = np.flatnonzero(keep)
        k = nm
        keys = np.concatenate([pos_kept * 4, starts * 4 + 1,
                               starts * 4 + 2])
        order = np.argsort(keys, kind="stable")
        out_ctx = np.concatenate([
            ctx[pos_kept], ctx[starts],
            np.full(k, num_contexts, dtype=np.int32)])[order]
        out_val = np.concatenate([
            val[pos_kept], lens - min_length, dists])[order]
        out_lz = np.concatenate([
            np.zeros(len(pos_kept), dtype=bool), np.ones(k, dtype=bool),
            np.zeros(k, dtype=bool)])[order]
        out_lists.append([TokenArray(out_ctx, out_val, out_lz)])
    return out_lists, True


def encode_context_map(context_map, num_histograms, writer: BitWriter) -> None:
    """enc_context_map.cc:63-150 (simplified: chooses simple vs MTF-ANS)."""
    if num_histograms == 1:
        writer.write(1, 1)
        writer.write(2, 0)
        return
    entry_bits = max(1, (num_histograms - 1).bit_length())
    if entry_bits < 4 and entry_bits * len(context_map) < 512:
        writer.write(1, 1)
        writer.write(2, entry_bits)
        for entry in context_map:
            writer.write(entry_bits, entry)
        return
    # MTF + single ANS stream
    mtf = _MtfEncoder()
    transformed = [mtf.encode(v) for v in context_map]
    tokens = [Token(0, v) for v in transformed]
    writer.write(1, 0)  # not simple
    writer.write(1, 1)  # use mtf
    codes, _ = build_and_encode_histograms(
        [tokens], 1, writer, uint_config=HybridUintConfig(2, 0, 1),
        allow_clustering=False)
    write_tokens(tokens, codes, [0], writer)


def build_and_encode_histograms(tokens_list, num_contexts, writer: BitWriter,
                                uint_config: HybridUintConfig = DEFAULT_UINT_CONFIG,
                                allow_clustering: bool = True,
                                strategy: str = "fast",
                                lz77_method: str = "none",
                                lz77_dist_symbol: int = 0,
                                lz77_widths=None,
                                force_log_alpha: int = None,
                                use_prefix: bool = False):
    """BuildAndEncodeHistograms (enc_ans.cc:1521-1608 via HistogramBuilder).

    Encodes LZ77 params, context map, uint configs and histograms into
    `writer`; returns (EntropyEncodingData, context_map).
    lz77_method: "none" or "rle" (ApplyLZ77_RLE; enabled only when the
    estimated saving clears the reference's acceptance threshold).
    """
    codes = EntropyEncodingData()
    if lz77_method in ("rle", "rle_fast", "lz77", "optimal") \
            and num_contexts + 1 <= 256:
        lz77 = LZ77Params()
        lz77.set_default()
        if lz77_method == "optimal":
            new_lists, accepted = _apply_lz77_optimal(
                tokens_list, num_contexts, lz77, uint_config,
                widths=lz77_widths)
            if not accepted:
                new_lists, accepted = _apply_lz77_rle(
                    tokens_list, num_contexts, lz77, uint_config,
                    lz77_dist_symbol)
        elif lz77_method == "lz77":
            new_lists, accepted = _apply_lz77_chain(
                tokens_list, num_contexts, lz77, uint_config,
                widths=lz77_widths)
            if not accepted:
                # screenshot-free content: the cheap RLE transform may
                # still clear the acceptance bar (enc_ans.cc kRLE)
                new_lists, accepted = _apply_lz77_rle(
                    tokens_list, num_contexts, lz77, uint_config,
                    lz77_dist_symbol)
        else:
            new_lists, accepted = _apply_lz77_rle(
                tokens_list, num_contexts, lz77, uint_config,
                lz77_dist_symbol, cost_free=lz77_method == "rle_fast")
        if accepted:
            lz77.enabled = True
            tokens_list = new_lists
            codes.lz77 = lz77
            codes.lz77_tokens = new_lists
    if codes.lz77.enabled:
        codes.lz77.write(writer)
        _encode_uint_config(codes.lz77.length_uint_config, writer, 8)
        num_contexts += 1
    else:
        # LZ77 disabled
        writer.write(1, 0)
    # histograms per context
    codes.tokenized = []
    histograms = _estimate_token_cost(tokens_list, num_contexts, uint_config,
                                      codes.lz77 if codes.lz77.enabled
                                      else None, collect=codes.tokenized)
    if num_contexts > 1:
        if allow_clustering:
            clustered, context_map = cluster_histograms(histograms,
                                                        CLUSTERS_LIMIT)
        else:
            clustered, context_map = [histograms[0]], [0] * num_contexts
        encode_context_map(context_map, len(clustered), writer)
    else:
        clustered, context_map = [histograms[0]], [0]
    num_histograms = len(clustered)
    # log_alpha_size: max token must fit in 1 << log_alpha for ANS
    max_token = 0
    for h in clustered:
        nz = [i for i, c in enumerate(h) if c > 0]
        if nz:
            max_token = max(max_token, nz[-1])
    log_alpha_size = max(5, max_token.bit_length())
    if force_log_alpha is not None:
        log_alpha_size = max(log_alpha_size, force_log_alpha)
    if log_alpha_size > 8:
        raise JXLError("token too large for ANS alphabet; "
                       "increase split_exponent")
    codes.log_alpha_size = log_alpha_size
    codes.uint_config = [uint_config] * num_histograms
    if use_prefix:
        # prefix-code path (enc_huffman.cc): decoder-speed-tier streams
        from .histogram import store_varlen_uint16
        from .params import PREFIX_MAX_BITS
        from .prefix import build_and_write_prefix_code

        codes.use_prefix_code = True
        writer.write(1, 1)
        for _ in range(num_histograms):
            _encode_uint_config(uint_config, writer, PREFIX_MAX_BITS)
        alpha_sizes = []
        for h in clustered:
            nz = [i for i, c in enumerate(h) if c > 0]
            alpha_sizes.append((nz[-1] + 1) if nz else 1)
            store_varlen_uint16(alpha_sizes[-1] - 1, writer)
        for h, alpha in zip(clustered, alpha_sizes):
            if alpha > 1:
                codes.encoding_info.append(
                    build_and_write_prefix_code(h[:alpha], alpha, writer))
            else:
                codes.encoding_info.append({0: (0, 0)})
        return codes, context_map
    writer.write(1, 0)  # use_prefix_code = 0
    writer.write(2, log_alpha_size - 5)
    for _ in range(num_histograms):
        _encode_uint_config(uint_config, writer, log_alpha_size)
    for h in clustered:
        counts, alphabet_size = encode_histogram_counts(h, writer, strategy)
        table = init_alias_table(counts, log_alpha_size)
        rev, freqs = build_reverse_map(table, alphabet_size)
        codes.encoding_info.append((freqs, rev))
    return codes, context_map


def encode_histogram_counts(h, writer: BitWriter, strategy: str = "fast"):
    """Serialize one (un-normalized) histogram; returns the normalized
    counts actually signaled (the exact table the decoder reconstructs)
    and the alphabet size. Extracted so streaming encoders can serialize
    histogram blobs separately from the section payloads."""
    alphabet_size = max(1, len(h) - _trailing_zeros(h))
    hist = h[:alphabet_size]
    counts = list(hist)
    if sum(counts) == 0:
        counts[0] = ANS_TAB_SIZE
        omit_pos, num_symbols, symbols = 0, 1, [0]
        encode_counts(counts, alphabet_size, omit_pos, num_symbols, 0,
                      symbols, writer)
    else:
        method, _ = compute_best_method(hist, alphabet_size, strategy)
        if method == 0:
            counts = create_flat_histogram(alphabet_size, ANS_TAB_SIZE)
            encode_flat_histogram(alphabet_size, writer)
        else:
            shift = method - 1
            omit_pos, num_symbols, symbols = normalize_counts(
                counts, ANS_LOG_TAB_SIZE, shift)
            encode_counts(counts, alphabet_size, omit_pos, num_symbols,
                          shift, symbols, writer)
    return counts, alphabet_size


def _trailing_zeros(h) -> int:
    n = 0
    for c in reversed(h):
        if c != 0:
            break
        n += 1
    return min(n, len(h) - 1)


def _encode_uint_config(cfg: HybridUintConfig, writer, log_alpha_size: int):
    """enc_ans.cc:543-556."""
    nbits = _ceil_log2(log_alpha_size + 1)
    writer.write(nbits, cfg.split_exponent)
    if cfg.split_exponent == log_alpha_size:
        return
    nbits = _ceil_log2(cfg.split_exponent + 1)
    writer.write(nbits, cfg.msb_in_token)
    nbits = _ceil_log2(cfg.split_exponent - cfg.msb_in_token + 1)
    writer.write(nbits, cfg.lsb_in_token)


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def _native_tables(codes: EntropyEncodingData):
    """Flattened per-histogram (freqs, offsets, reverse-map) tables for
    the C writer; cached on the codes object."""
    cached = getattr(codes, "_native_tables", None)
    if cached is not None:
        return cached
    info = codes.encoding_info
    nhisto = len(info)
    alpha_max = max(len(freqs) for freqs, _ in info)
    freqs_all = np.zeros((nhisto, alpha_max), dtype=np.uint16)
    offs_all = np.zeros((nhisto, alpha_max), dtype=np.uint32)
    rev_all = np.zeros((nhisto, ANS_TAB_SIZE), dtype=np.uint16)
    for i, (freqs, rev) in enumerate(info):
        f = np.asarray(freqs, dtype=np.int64)
        freqs_all[i, :len(f)] = f
        offs = np.concatenate(([0], np.cumsum(f)[:-1]))
        offs_all[i, :len(f)] = offs
        flat = np.concatenate(
            [rev[s, :f[s]] for s in range(len(f))]) if len(f) else \
            np.zeros(0, dtype=np.int64)
        rev_all[i, :len(flat)] = flat
    codes._native_tables = (freqs_all, offs_all, rev_all, alpha_max)
    return codes._native_tables


def write_tokens(tokens, codes: EntropyEncodingData, context_map,
                 writer: BitWriter, context_offset: int = 0,
                 pretok=None) -> int:
    """WriteTokens ANS path (enc_ans.cc:1728-1813). Returns extra bits.

    Uses the native C rANS emitter (native/ans_write.c) when available;
    falls back to a pure-Python loop otherwise.
    pretok: optional (ctx, tok, nbits, bits) from codes.tokenized to skip
    re-tokenizing."""
    if pretok is not None:
        ctx, tok, nbits, bits = pretok
        n = len(tok)
    else:
        ctx, val, lz = flatten_tokens(tokens)
        n = len(val)
    if n == 0:
        writer.write(32, ANS_SIGNATURE << 16)
        return 0
    cmap = np.asarray(context_map, dtype=np.int64)
    histo = cmap[ctx + context_offset]
    if pretok is None:
        # all clustered uint configs are identical in this encoder
        cfg = codes.uint_config[0]
        tok, nbits, bits = _tokenize_arrays(ctx, val, lz, cfg, codes.lz77)
    num_extra_bits = int(nbits.astype(np.int64).sum())

    if codes.use_prefix_code:
        # prefix path: code words stream FORWARD (WriteTokens prefix arm)
        from .prefix import _write_msb

        for i in range(n):
            ln, code = codes.encoding_info[int(histo[i])][int(tok[i])]
            if ln:
                _write_msb(writer, ln, code)
            if nbits[i]:
                writer.write(int(nbits[i]), int(bits[i]))
        return num_extra_bits

    from ..native_ext import ans_write_native, get_lib

    lib = get_lib()
    if lib is not None and hasattr(lib, "ans_write_tokens") and n >= 64:
        freqs_all, offs_all, rev_all, alpha_max = _native_tables(codes)
        state, out_bytes, total_bits = ans_write_native(
            lib, histo, tok, nbits, bits, freqs_all, offs_all, rev_all,
            alpha_max, ANS_SIGNATURE << 16)
        writer.write(32, state & 0xFFFFFFFF)
        writer.append_raw_bits(out_bytes, total_bits)
        return num_extra_bits

    out = []  # list of (nbits, bits), to be written reversed
    state = ANS_SIGNATURE << 16
    for i in range(n - 1, -1, -1):
        h = int(histo[i])
        t = int(tok[i])
        freqs, rev = codes.encoding_info[h]
        freq = int(freqs[t])
        if freq <= 0:
            raise JXLError("token with zero frequency")
        if nbits[i]:
            out.append((int(nbits[i]), int(bits[i])))
        # PutSymbol (enc_ans.h:53-66)
        if (state >> (32 - ANS_LOG_TAB_SIZE)) >= freq:
            out.append((16, state & 0xFFFF))
            state >>= 16
        state = ((state // freq) << ANS_LOG_TAB_SIZE) \
            + int(rev[t, state % freq])
    writer.write(32, state & 0xFFFFFFFF)
    for nb, b in reversed(out):
        writer.write(nb, b)
    return num_extra_bits
