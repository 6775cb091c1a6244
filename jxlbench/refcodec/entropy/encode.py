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


def _estimate_token_cost(tokens_list, num_contexts, uint_config,
                         collect=None):
    """collect: optional list; receives (ctx, tok, nbits, bits) per stream
    so the write pass can skip re-tokenizing."""
    from ..native_ext import get_lib, hybrid_tokenize_native

    n_bins = num_contexts * _MAX_TOK
    lib = get_lib()
    use_native = lib is not None and hasattr(lib, "hybrid_tokenize")
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
        tok, nbits, bits = _tokenize_arrays(ctx, val, lz, uint_config, None)
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
                                strategy: str = "fast"):
    """BuildAndEncodeHistograms (enc_ans.cc:1521-1608 via HistogramBuilder).

    Encodes the LZ77 params (disabled), context map, uint configs and
    histograms into `writer`; returns (EntropyEncodingData, context_map).
    """
    codes = EntropyEncodingData()
    writer.write(1, 0)  # LZ77 disabled
    # histograms per context
    codes.tokenized = []
    histograms = _estimate_token_cost(tokens_list, num_contexts, uint_config,
                                      collect=codes.tokenized)
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
    if log_alpha_size > 8:
        raise JXLError("token too large for ANS alphabet; "
                       "increase split_exponent")
    codes.log_alpha_size = log_alpha_size
    codes.uint_config = [uint_config] * num_histograms
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
