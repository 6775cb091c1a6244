"""Brotli-style canonical prefix codes (JPEG XL "prefix code" alternative
to ANS).

Decode mirrors dec_huffman.cc (simple codes + code-length-code header);
encode mirrors enc_huffman.cc/enc_huffman_tree.cc. Codes are read MSB-first
from the LSB-first bitstream (Brotli convention).
"""

from __future__ import annotations

import heapq

from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from .params import PREFIX_MAX_BITS

CODE_LENGTH_CODES = 18
CODE_LENGTH_CODE_ORDER = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12,
                          13, 14, 15)
DEFAULT_CODE_LENGTH = 8
CODE_LENGTH_REPEAT_CODE = 16

# Static code for the code-length-code lengths, indexed by 4 peeked bits
# -> (bits, value) (dec_huffman.cc:204-207).
_CL_HUFF = [
    (2, 0), (2, 4), (2, 3), (3, 2), (2, 0), (2, 4), (2, 3), (4, 1),
    (2, 0), (2, 4), (2, 3), (3, 2), (2, 0), (2, 4), (2, 3), (4, 5),
]


class PrefixCode:
    """Canonical prefix decoder: decode bit-by-bit via (len, code) dict."""

    __slots__ = ("map", "max_bits", "single_symbol")

    def __init__(self, code_lengths):
        self.single_symbol = None
        nz = [(l, s) for s, l in enumerate(code_lengths) if l > 0]
        if not nz:
            # degenerate: symbol 0 with zero bits
            self.single_symbol = 0
            self.map = {}
            self.max_bits = 0
            return
        if len(nz) == 1:
            self.single_symbol = nz[0][1]
            self.map = {}
            self.max_bits = 0
            return
        # canonical assignment: sort by (length, symbol), MSB-first codes
        nz.sort()
        self.map = {}
        code = 0
        prev_len = nz[0][0]
        for length, sym in nz:
            code <<= (length - prev_len)
            prev_len = length
            self.map[(length, code)] = sym
            code += 1
        self.max_bits = nz[-1][0]
        # completeness check (space must be exactly filled)
        space = sum(1 << (PREFIX_MAX_BITS - l) for l, _ in nz)
        if space != (1 << PREFIX_MAX_BITS):
            raise JXLError("prefix code not complete")

    def read_symbol(self, r: BitReader) -> int:
        if self.single_symbol is not None:
            return self.single_symbol
        code = 0
        for length in range(1, self.max_bits + 1):
            code = (code << 1) | r.read_bits(1)
            sym = self.map.get((length, code))
            if sym is not None:
                return sym
        raise JXLError("invalid prefix code bits")


def _read_code_lengths(cl_code_lengths, num_symbols, r: BitReader):
    """ReadHuffmanCodeLengths (dec_huffman.cc:26-95).

    Builds a small canonical decoder over the 18 code-length codes (no
    15-bit completeness requirement applies to this inner code)."""
    nz = [(l, s) for s, l in enumerate(cl_code_lengths) if l > 0]
    nz.sort()
    table = {}
    code = 0
    prev_len = nz[0][0] if nz else 0
    for length, sym in nz:
        code <<= (length - prev_len)
        prev_len = length
        table[(length, code)] = sym
        code += 1
    single = nz[0][1] if len(nz) == 1 else None

    def read_cl_symbol():
        if single is not None:
            return single
        c = 0
        for length in range(1, 6):
            c = (c << 1) | r.read_bits(1)
            s = table.get((length, c))
            if s is not None:
                return s
        raise JXLError("invalid code-length code")

    code_lengths = [0] * num_symbols
    symbol = 0
    prev_code_len = DEFAULT_CODE_LENGTH
    repeat = 0
    repeat_code_len = 0
    space = 32768
    while symbol < num_symbols and space > 0:
        code_len = read_cl_symbol()
        if code_len < CODE_LENGTH_REPEAT_CODE:
            repeat = 0
            code_lengths[symbol] = code_len
            symbol += 1
            if code_len != 0:
                prev_code_len = code_len
                space -= 32768 >> code_len
        else:
            extra_bits = code_len - 14
            new_len = prev_code_len if code_len == CODE_LENGTH_REPEAT_CODE else 0
            if repeat_code_len != new_len:
                repeat = 0
                repeat_code_len = new_len
            old_repeat = repeat
            if repeat > 0:
                repeat -= 2
                repeat <<= extra_bits
            repeat += r.read_bits(extra_bits) + 3
            repeat_delta = repeat - old_repeat
            if symbol + repeat_delta > num_symbols:
                raise JXLError("prefix code repeat overflow")
            for _ in range(repeat_delta):
                code_lengths[symbol] = repeat_code_len
                symbol += 1
            if repeat_code_len != 0:
                space -= repeat_delta << (15 - repeat_code_len)
    if space != 0:
        raise JXLError("prefix code lengths under/overfull")
    return code_lengths


class _SimplePrefixCode:
    """Decoder for simple codes with explicit code lengths (not canonical):
    dec_huffman.cc:97-186 assigns specific codes per arity."""

    __slots__ = ("table",)

    def __init__(self, entries):
        # entries: list of (nbits, lsb_first_code, symbol)
        self.table = {(n, c): s for n, c, s in entries}

    def read_symbol(self, r: BitReader) -> int:
        code = 0
        for length in range(1, 16):
            code |= r.read_bits(1) << (length - 1)  # LSB-first accumulation
            s = self.table.get((length, code))
            if s is not None:
                return s
        raise JXLError("invalid simple prefix code")


def _read_simple_code(alphabet_size: int, r: BitReader):
    """dec_huffman.cc:97-186. Simple codes' bit patterns are indexes into a
    small table read LSB-first; we reproduce the exact code assignment."""
    max_bits = (alphabet_size - 1).bit_length() if alphabet_size > 1 else 0
    num_symbols = r.read_bits(2) + 1
    symbols = [r.read_bits(max_bits) for _ in range(num_symbols)]
    for s in symbols:
        if s >= alphabet_size:
            raise JXLError("invalid symbol in simple code")
    if len(set(symbols)) != len(symbols):
        raise JXLError("duplicate symbol in simple code")
    if num_symbols == 4:
        num_symbols += r.read_bits(1)
    s = symbols
    if num_symbols == 1:
        entries = [(0, 0, s[0])]
        pc = PrefixCode([])
        pc.single_symbol = s[0]
        return pc
    if num_symbols == 2:
        a, b = sorted(s[:2])
        entries = [(1, 0, a), (1, 1, b)]
    elif num_symbols == 3:
        a = s[0]
        b, c = sorted(s[1:3])
        entries = [(1, 0, a), (2, 1, b), (2, 3, c)]
    elif num_symbols == 4:
        a, b, c, d = sorted(s[:4])
        entries = [(2, 0, a), (2, 2, b), (2, 1, c), (2, 3, d)]
    else:  # 5: tree 1/2/3/3
        a, b = s[0], s[1]
        c, d = sorted(s[2:4])
        entries = [(1, 0, a), (2, 1, b), (3, 3, c), (3, 7, d)]
    return _SimplePrefixCode(entries)


def read_prefix_code(alphabet_size: int, r: BitReader):
    """HuffmanDecodingData::ReadFromBitStream (dec_huffman.cc:188-240)."""
    if alphabet_size > (1 << PREFIX_MAX_BITS):
        raise JXLError("alphabet too large for prefix code")
    simple_or_skip = r.read_bits(2)
    if simple_or_skip == 1:
        return _read_simple_code(alphabet_size, r)
    cl_code_lengths = [0] * CODE_LENGTH_CODES
    space = 32
    num_codes = 0
    for i in range(simple_or_skip, CODE_LENGTH_CODES):
        if space <= 0:
            break
        idx = CODE_LENGTH_CODE_ORDER[i]
        peek = r.peek_bits(4)
        nbits, v = _CL_HUFF[peek]
        r.skip_bits(nbits)
        cl_code_lengths[idx] = v
        if v != 0:
            space -= 32 >> v
            num_codes += 1
    if not (num_codes == 1 or space == 0):
        raise JXLError("invalid code-length code")
    code_lengths = _read_code_lengths(cl_code_lengths, alphabet_size, r)
    return PrefixCode(code_lengths)


# --------------------------------------------------------------------- encode
def build_prefix_code_lengths(histogram, max_bits: int = PREFIX_MAX_BITS):
    """Length-limited Huffman code lengths from counts (package-merge-lite:
    plain Huffman + heuristic rebalancing like enc_huffman_tree.cc)."""
    n = len(histogram)
    nz = [(c, i) for i, c in enumerate(histogram) if c > 0]
    if len(nz) <= 1:
        lengths = [0] * n
        if nz:
            lengths[nz[0][1]] = 1
        return lengths
    for _ in range(max_bits):
        heap = [(c, (i,)) for c, i in nz]
        heapq.heapify(heap)
        lengths = [0] * n
        while len(heap) > 1:
            c1, s1 = heapq.heappop(heap)
            c2, s2 = heapq.heappop(heap)
            for i in s1 + s2:
                lengths[i] += 1
            heapq.heappush(heap, (c1 + c2, s1 + s2))
        if max(lengths) <= max_bits:
            return lengths
        # flatten histogram and retry (enc_huffman_tree.cc approach)
        nz = [((c + 1) // 2, i) for c, i in nz]
    raise JXLError("could not limit prefix code length")


_CL_STATIC = {0: (2, 0), 4: (2, 1), 3: (2, 2), 2: (3, 3), 1: (4, 7),
              5: (4, 15)}  # inverse of _CL_HUFF (LSB-first patterns)


def canonical_code_table(code_lengths):
    """sym -> (length, MSB-first code), matching PrefixCode's decoder."""
    nz = sorted((l, s) for s, l in enumerate(code_lengths) if l > 0)
    out = {}
    code = 0
    prev = nz[0][0] if nz else 0
    for length, sym in nz:
        code <<= (length - prev)
        prev = length
        out[sym] = (length, code)
        code += 1
    return out


def _write_msb(w: BitWriter, length: int, code: int) -> None:
    for i in range(length - 1, -1, -1):
        w.write(1, (code >> i) & 1)


def build_and_write_prefix_code(hist, alphabet_size: int, w: BitWriter):
    """Build a length-limited prefix code for `hist`, serialize it
    (enc_huffman.cc StoreHuffmanTree analog) and return
    {sym: (length, code)} for token emission. Handles the simple-code
    forms for <= 4 distinct symbols."""
    counts = list(hist) + [0] * (alphabet_size - len(hist))
    nz_syms = [s for s, c in enumerate(counts) if c > 0]
    if not nz_syms:
        nz_syms = [0]
    max_bits_sym = (alphabet_size - 1).bit_length() if alphabet_size > 1 \
        else 0
    if len(nz_syms) == 1:
        w.write(2, 1)  # simple
        w.write(2, 0)  # 1 symbol
        w.write(max_bits_sym, nz_syms[0])
        return {nz_syms[0]: (0, 0)}
    if len(nz_syms) <= 4:
        # simple code; decoder assigns per-arity patterns
        # (dec_huffman.cc:97-186)
        n = len(nz_syms)
        w.write(2, 1)
        w.write(2, n - 1)
        if n == 2:
            a, b = sorted(nz_syms)
            for s in (a, b):
                w.write(max_bits_sym, s)
            return {a: (1, 0), b: (1, 1)}
        if n == 3:
            # first listed symbol gets the 1-bit code: pick most frequent
            first = max(nz_syms, key=lambda s: counts[s])
            rest = sorted(s for s in nz_syms if s != first)
            for s in (first, *rest):
                w.write(max_bits_sym, s)
            return {first: (1, 0), rest[0]: (2, 0b10), rest[1]: (2, 0b11)}
        # n == 4: flat 2-bit code (tree-select bit 0)
        syms = sorted(nz_syms)
        for s in syms:
            w.write(max_bits_sym, s)
        w.write(1, 0)
        return {s: (2, i) for i, s in enumerate(syms)}
    lengths = build_prefix_code_lengths(counts, PREFIX_MAX_BITS)
    # --- serialize via the code-length code
    # 1) build the cl-symbol stream (literals + repeat-zero code 17)
    cl_stream = []  # (cl_symbol, extra_nbits, extra_bits)
    i = 0
    n = len(lengths)
    last = max(s for s, l in enumerate(lengths) if l)
    prev_was_17 = False
    while i <= last:
        l = lengths[i]
        if l == 0:
            run = 0
            while i + run <= last and lengths[i + run] == 0:
                run += 1
            while run >= 3 and not prev_was_17:
                chunk = min(run, 10)
                cl_stream.append((17, 3, chunk - 3))
                run -= chunk
                i += chunk
                prev_was_17 = True
            for _ in range(run):
                cl_stream.append((0, 0, 0))
                i += 1
                prev_was_17 = False
        else:
            cl_stream.append((l, 0, 0))
            i += 1
            prev_was_17 = False
    # 2) code-length code over the cl symbols
    cl_hist = [0] * CODE_LENGTH_CODES
    for sym, _, _ in cl_stream:
        cl_hist[sym] += 1
    cl_lengths = build_prefix_code_lengths(cl_hist, 5)
    w.write(2, 0)  # complex, no skip
    space = 32
    for idx in CODE_LENGTH_CODE_ORDER:
        if space <= 0:
            break
        v = cl_lengths[idx]
        nbits, pattern = _CL_STATIC[v]
        w.write(nbits, pattern)
        if v:
            space -= 32 >> v
    cl_table = canonical_code_table(cl_lengths)
    single_cl = len([1 for v in cl_lengths if v]) == 1
    # 3) emit the stream (single-cl-symbol codes cost zero bits)
    for sym, extra_n, extra in cl_stream:
        if not single_cl:
            ln, code = cl_table[sym]
            _write_msb(w, ln, code)
        if extra_n:
            w.write(extra_n, extra)
    return canonical_code_table(lengths)
