"""Entropy decoding: histogram sets, context maps, rANS/prefix symbol reader.

Mirrors DecodeHistograms/DecodeContextMap/ANSSymbolReader
(dec_ans.cc:188-416, dec_ans.h:160-380, dec_context_map.cc).
"""

from __future__ import annotations

import numpy as np

from .. import native_ext
from ..base.status import JXLError
from ..io.bits import BitReader
from ..io.fields import BitsOffset, Bundle, U32Enc, Val
from .alias import AliasTable, alias_table_views, init_alias_table
from .histogram import decode_varlen_uint16, read_histogram
from .hybrid_uint import HybridUintConfig
from .params import (
    ANS_LOG_TAB_SIZE,
    ANS_MAX_ALPHABET_SIZE,
    ANS_SIGNATURE,
    ANS_TAB_SIZE,
    LZ77_WINDOW_SIZE,
    PREFIX_MAX_BITS,
)
from .prefix import PrefixCode, read_prefix_code

# Special LZ77 distances (dec_ans.h:120-141), from WebP lossless.
SPECIAL_DISTANCES = [
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7),
]
NUM_SPECIAL_DISTANCES = len(SPECIAL_DISTANCES)


def special_distance(index: int, multiplier: int) -> int:
    a, b = SPECIAL_DISTANCES[index]
    dist = a + multiplier * b
    return dist if dist > 1 else 1


class LZ77Params(Bundle):
    """dec_ans.cc:324-334."""

    def visit_fields(self, v):
        v.bool_(self, False, "enabled")
        if not v.conditional(self.enabled):
            return
        v.u32(self, U32Enc(Val(224), Val(512), Val(4096), BitsOffset(15, 8)),
              224, "min_symbol")
        v.u32(self, U32Enc(Val(3), Val(4), BitsOffset(2, 5), BitsOffset(8, 9)),
              3, "min_length")

    def set_default(self):
        self.enabled = False
        self.min_symbol = 224
        self.min_length = 3
        self.length_uint_config = HybridUintConfig(0, 0, 0)
        self.nonserialized_distance_context = 0


def decode_uint_config(log_alpha_size: int, r: BitReader) -> HybridUintConfig:
    """dec_ans.cc:262-287."""
    split_exponent = r.read_bits(_ceil_log2(log_alpha_size + 1))
    msb = lsb = 0
    if split_exponent != log_alpha_size:
        nbits = _ceil_log2(split_exponent + 1)
        msb = r.read_bits(nbits)
        if msb > split_exponent:
            raise JXLError("invalid HybridUintConfig")
        nbits = _ceil_log2(split_exponent - msb + 1)
        lsb = r.read_bits(nbits)
    if lsb + msb > split_exponent:
        raise JXLError("invalid HybridUintConfig")
    return HybridUintConfig(split_exponent, msb, lsb)


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def inverse_move_to_front(values: list) -> list:
    lib = native_ext.get_lib() if len(values) >= 64 else None
    if lib is not None:
        arr = np.array(values, dtype=np.uint32)
        native_ext.inverse_mtf_native(lib, arr)
        return arr.tolist()
    mtf = list(range(256))
    out = []
    for idx in values:
        val = mtf[idx]
        out.append(val)
        del mtf[idx]
        mtf.insert(0, val)
    return out


def decode_context_map(num_contexts: int, r: BitReader):
    """dec_context_map.cc:46-95. Returns (context_map, num_histograms)."""
    context_map = [0] * num_contexts
    if r.read_bits(1):  # simple
        bits_per_entry = r.read_bits(2)
        if bits_per_entry != 0:
            context_map = [r.read_bits(bits_per_entry)
                           for _ in range(num_contexts)]
    else:
        use_mtf = bool(r.read_bits(1))
        code, sink_map = decode_histograms(
            r, 1, disallow_lz77=num_contexts <= 2)
        reader = ANSSymbolReader(code, r)
        native = None
        if (not code.use_prefix_code and not code.lz77.enabled
                and num_contexts >= 64):
            lib = native_ext.get_lib()
            if lib is not None:
                native = native_ext.ans_read_uints_native(
                    lib, r.data, r.total_bits_consumed(), reader.state,
                    native_ext.NativeCodes(code, sink_map), num_contexts, 0)
        if native is not None:
            vals, bitpos, reader.state = native
            r.seek_bits(bitpos)
            return _checked_context_map(lib, vals, reader, use_mtf)
        maxsym = 0
        for i in range(num_contexts):
            sym = reader.read_hybrid_uint(0, r, sink_map)
            maxsym = max(maxsym, sym)
            context_map[i] = sym
        if maxsym >= 256:
            raise JXLError("invalid cluster ID")
        if not reader.check_final_state():
            raise JXLError("invalid context map ANS stream")
        if use_mtf:
            context_map = inverse_move_to_front(context_map)
    num_histograms = max(context_map) + 1
    if set(context_map) != set(range(num_histograms)):
        raise JXLError("incomplete context map")
    return context_map, num_histograms


def _checked_context_map(lib, vals: np.ndarray, reader, use_mtf: bool):
    """decode_context_map's checks and inverse move-to-front over the
    natively read u32 map, in place; the map becomes a list once."""
    if vals.max() >= 256:
        raise JXLError("invalid cluster ID")
    if not reader.check_final_state():
        raise JXLError("invalid context map ANS stream")
    if use_mtf:
        native_ext.inverse_mtf_native(lib, vals)
    num_histograms = int(vals.max()) + 1
    if np.count_nonzero(np.bincount(vals, minlength=num_histograms)) \
            != num_histograms:
        raise JXLError("incomplete context map")
    return vals.tolist(), num_histograms


class ANSCode:
    """Decoded histogram set (dec_ans.h:146-159)."""

    def __init__(self):
        self.use_prefix_code = False
        self.log_alpha_size = 8
        self.uint_config: list = []
        self.alias_tables: list = []   # AliasTable per histogram
        self.prefix_codes: list = []   # PrefixCode per histogram
        self.degenerate_symbols: list = []
        self.lz77 = LZ77Params()


def decode_histograms(r: BitReader, num_contexts: int,
                      disallow_lz77: bool = False):
    """DecodeHistograms (dec_ans.cc:336-370).
    Returns (ANSCode, context_map)."""
    return decode_histogram_set(r, num_contexts, disallow_lz77)[:2]


def decode_histogram_set(r: BitReader, num_contexts: int,
                         disallow_lz77: bool = False):
    """decode_histograms, and whether the set's ANS histograms were read
    and made alias tables in C (native_ext.decode_ans_histograms_native,
    wherever the library is there). Returns (ANSCode, context_map,
    native)."""
    code = ANSCode()
    code.lz77.read(r)
    if code.lz77.enabled:
        if disallow_lz77:
            raise JXLError("LZ77 disallowed here")
        num_contexts += 1
        code.lz77.length_uint_config = decode_uint_config(8, r)
    if num_contexts > 1:
        context_map, num_histograms = decode_context_map(num_contexts, r)
    else:
        context_map, num_histograms = [0], 1
    code.lz77.nonserialized_distance_context = context_map[-1]
    code.use_prefix_code = bool(r.read_bits(1))
    if code.use_prefix_code:
        code.log_alpha_size = PREFIX_MAX_BITS
    else:
        code.log_alpha_size = r.read_bits(2) + 5
    code.uint_config = [decode_uint_config(code.log_alpha_size, r)
                        for _ in range(num_histograms)]
    code.degenerate_symbols = [-1] * num_histograms
    if code.use_prefix_code:
        alphabet_sizes = [decode_varlen_uint16(r) + 1
                          for _ in range(num_histograms)]
        for size in alphabet_sizes:
            if size > (1 << PREFIX_MAX_BITS):
                raise JXLError("alphabet size too large")
        for c in range(num_histograms):
            if alphabet_sizes[c] > 1:
                code.prefix_codes.append(read_prefix_code(alphabet_sizes[c], r))
            else:
                p = PrefixCode([])  # degenerate: always symbol 0, zero bits
                p.single_symbol = 0
                code.prefix_codes.append(p)
        return code, context_map, False
    lib = native_ext.get_lib()
    if lib is not None:
        tables, code.degenerate_symbols = \
            native_ext.decode_ans_histograms_native(
                lib, r, num_histograms, code.log_alpha_size)
        code.alias_tables = alias_table_views(tables, code.log_alpha_size)
        return code, context_map, True
    for c in range(num_histograms):
        counts = read_histogram(r, ANS_LOG_TAB_SIZE)
        if len(counts) > ANS_MAX_ALPHABET_SIZE:
            raise JXLError("alphabet size too large")
        while counts and counts[-1] == 0:
            counts.pop()
        degenerate = len(counts) - 1 if counts else 0
        for s in range(max(0, degenerate)):
            if counts[s] != 0:
                degenerate = -1
                break
        code.degenerate_symbols[c] = degenerate
        code.alias_tables.append(
            init_alias_table(counts, code.log_alpha_size))
    return code, context_map, False


class ANSSymbolReader:
    """Sequential rANS/prefix token reader (dec_ans.h:160-380).

    Hot bulk decode paths use the vectorized interleaved reader in
    libjxl_tpu.entropy.vector_decode; this scalar version is the reference
    and handles LZ77.
    """

    def __init__(self, code: ANSCode, r: BitReader,
                 distance_multiplier: int = 0):
        self.code = code
        self.use_prefix_code = code.use_prefix_code
        if not self.use_prefix_code:
            self.state = r.read_bits(32)
            self.log_alpha_size = code.log_alpha_size
            self.log_entry_size = ANS_LOG_TAB_SIZE - code.log_alpha_size
        else:
            self.state = ANS_SIGNATURE << 16
        self.configs = code.uint_config
        # LZ77 state
        self.lz77_window = None
        if code.lz77.enabled:
            self.lz77_window = np.zeros(LZ77_WINDOW_SIZE, dtype=np.uint32)
            self.lz77_ctx = code.lz77.nonserialized_distance_context
            self.lz77_length_uint = code.lz77.length_uint_config
            self.lz77_threshold = code.lz77.min_symbol
            self.lz77_min_length = code.lz77.min_length
            self.num_special_distances = (
                NUM_SPECIAL_DISTANCES if distance_multiplier else 0)
            self.special = [special_distance(i, distance_multiplier)
                            for i in range(self.num_special_distances)]
        self.num_to_copy = 0
        self.copy_pos = 0
        self.num_decoded = 0

    def read_symbol(self, histo_idx: int, r: BitReader) -> int:
        if self.use_prefix_code:
            return self.code.prefix_codes[histo_idx].read_symbol(r)
        res = self.state & (ANS_TAB_SIZE - 1)
        table: AliasTable = self.code.alias_tables[histo_idx]
        value, offset, freq = table.lookup(res)
        self.state = freq * (self.state >> ANS_LOG_TAB_SIZE) + offset
        if self.state < (1 << 16):
            self.state = (self.state << 16) | r.read_bits(16)
        return value

    def check_final_state(self) -> bool:
        return self.use_prefix_code or self.state == (ANS_SIGNATURE << 16)

    def read_hybrid_uint_clustered(self, ctx: int, r: BitReader) -> int:
        """ctx is a *clustered* histogram index (dec_ans.h:287-345)."""
        win_mask = LZ77_WINDOW_SIZE - 1
        if self.lz77_window is not None and self.num_to_copy > 0:
            ret = int(self.lz77_window[self.copy_pos & win_mask])
            self.copy_pos += 1
            self.num_to_copy -= 1
            self.lz77_window[self.num_decoded & win_mask] = ret
            self.num_decoded += 1
            return ret
        token = self.read_symbol(ctx, r)
        if self.lz77_window is not None and token >= self.lz77_threshold:
            self.num_to_copy = self.lz77_length_uint.decode(
                token - self.lz77_threshold, r.read_bits) + self.lz77_min_length
            dist_token = self.read_symbol(self.lz77_ctx, r)
            distance = self.configs[self.lz77_ctx].decode(dist_token, r.read_bits)
            if distance < self.num_special_distances:
                distance = self.special[distance]
            else:
                distance = distance + 1 - self.num_special_distances
            if distance > self.num_decoded:
                distance = self.num_decoded
            if distance > LZ77_WINDOW_SIZE:
                distance = LZ77_WINDOW_SIZE
            self.copy_pos = self.num_decoded - distance
            if distance == 0:
                to_fill = min(self.num_to_copy, LZ77_WINDOW_SIZE)
                self.lz77_window[:to_fill] = 0
            if self.num_to_copy < self.lz77_min_length:
                return 0
            ret = int(self.lz77_window[self.copy_pos & win_mask])
            self.copy_pos += 1
            self.num_to_copy -= 1
            self.lz77_window[self.num_decoded & win_mask] = ret
            self.num_decoded += 1
            return ret
        ret = self.configs[ctx].decode(token, r.read_bits)
        if self.lz77_window is not None:
            self.lz77_window[self.num_decoded & win_mask] = ret
            self.num_decoded += 1
        return ret

    def read_hybrid_uint(self, ctx: int, r: BitReader, context_map) -> int:
        return self.read_hybrid_uint_clustered(context_map[ctx], r)
