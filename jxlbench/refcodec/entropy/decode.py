"""Entropy decoding: histogram sets, context maps, rANS/prefix symbol reader.

Mirrors DecodeHistograms/DecodeContextMap/ANSSymbolReader
(dec_ans.cc:188-416, dec_ans.h:160-380, dec_context_map.cc).
"""

from __future__ import annotations

import numpy as np

from ..base.status import JXLError
from ..io.bits import BitReader
from ..io.fields import BitsOffset, Bundle, U32Enc, Val
from .alias import AliasTable, init_alias_table
from .histogram import read_histogram
from .hybrid_uint import HybridUintConfig
from .params import (
    ANS_LOG_TAB_SIZE,
    ANS_MAX_ALPHABET_SIZE,
    ANS_SIGNATURE,
    ANS_TAB_SIZE,
)

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
    if len(values) >= 64:
        from ..native_ext import get_lib

        lib = get_lib()
        if lib is not None and hasattr(lib, "inverse_mtf"):
            import ctypes

            import numpy as np

            arr = np.ascontiguousarray(values, dtype=np.uint32)
            rc = lib.inverse_mtf(
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                ctypes.c_int(len(arr)))
            if rc != 0:
                raise JXLError("invalid MTF index")
            return [int(v) for v in arr]
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
        code, sink_map = decode_histograms(r, 1)
        reader = ANSSymbolReader(code, r)
        native = None
        if num_contexts >= 64:
            from ..native_ext import NativeCodes, ans_read_uints_native, \
                get_lib

            lib = get_lib()
            if lib is not None:
                native = ans_read_uints_native(
                    lib, r.data, r.total_bits_consumed(), reader.state,
                    NativeCodes(code, sink_map), num_contexts, 0)
        if native is not None:
            vals, bitpos, state = native
            maxsym = int(vals.max()) if num_contexts else 0
            context_map = [int(v) for v in vals]
            r.seek_bits(bitpos)
            reader.state = state
        else:
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


class ANSCode:
    """Decoded histogram set (dec_ans.h:146-159)."""

    def __init__(self):
        self.log_alpha_size = 8
        self.uint_config: list = []
        self.alias_tables: list = []   # AliasTable per histogram
        self.degenerate_symbols: list = []
        self.lz77 = LZ77Params()


def decode_histograms(r: BitReader, num_contexts: int):
    """DecodeHistograms (dec_ans.cc:336-370) of rANS codes without LZ77.
    Returns (ANSCode, context_map)."""
    code = ANSCode()
    code.lz77.read(r)
    if code.lz77.enabled:
        raise JXLError("LZ77: not in this copy")
    if num_contexts > 1:
        context_map, num_histograms = decode_context_map(num_contexts, r)
    else:
        context_map, num_histograms = [0], 1
    code.lz77.nonserialized_distance_context = context_map[-1]
    if r.read_bits(1):
        raise JXLError("prefix codes: not in this copy")
    code.log_alpha_size = r.read_bits(2) + 5
    code.uint_config = [decode_uint_config(code.log_alpha_size, r)
                        for _ in range(num_histograms)]
    code.degenerate_symbols = [-1] * num_histograms
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
    return code, context_map


class ANSSymbolReader:
    """Sequential rANS token reader (dec_ans.h:160-380), without LZ77.

    Hot bulk decode paths run in native C; this scalar version reads the
    short streams (context maps, permutations, modular channels the
    native decoder declines)."""

    def __init__(self, code: ANSCode, r: BitReader):
        self.code = code
        self.state = r.read_bits(32)
        self.log_alpha_size = code.log_alpha_size
        self.log_entry_size = ANS_LOG_TAB_SIZE - code.log_alpha_size
        self.configs = code.uint_config

    def read_symbol(self, histo_idx: int, r: BitReader) -> int:
        res = self.state & (ANS_TAB_SIZE - 1)
        table: AliasTable = self.code.alias_tables[histo_idx]
        value, offset, freq = table.lookup(res)
        self.state = freq * (self.state >> ANS_LOG_TAB_SIZE) + offset
        if self.state < (1 << 16):
            self.state = (self.state << 16) | r.read_bits(16)
        return value

    def check_final_state(self) -> bool:
        return self.state == (ANS_SIGNATURE << 16)

    def read_hybrid_uint_clustered(self, ctx: int, r: BitReader) -> int:
        """ctx is a *clustered* histogram index (dec_ans.h:287-345)."""
        token = self.read_symbol(ctx, r)
        return self.configs[ctx].decode(token, r.read_bits)

    def read_hybrid_uint(self, ctx: int, r: BitReader, context_map) -> int:
        return self.read_hybrid_uint_clustered(context_map[ctx], r)
