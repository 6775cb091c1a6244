"""Brotli (RFC 7932) subset codec for `brob` boxes and jbrd metadata.

The container spec compresses metadata boxes with Brotli
(box_content_decoder.h:25; encode.cc brob writer). This module provides:

- `brotli_store`: a fully spec-compliant Brotli *writer* that emits
  uncompressed (IsUncompressed) meta-blocks — decodable by any Brotli
  implementation; used when this framework writes brob/jbrd boxes.
- `brotli_decode`: a decoder for the subset of streams that do not
  reference the 122 KB static dictionary (dictionary data is not
  embedded here) and do not need literal-context modeling with more
  than one literal tree. It fully supports uncompressed meta-blocks,
  MSKIPLEN metadata blocks, compressed meta-blocks with arbitrary
  insert&copy/distance coding, block switching, and the distance cache.

Out-of-scope streams raise JXLError with a precise reason.
"""

from __future__ import annotations

import ctypes
import ctypes.util

from ..base.status import JXLError

_enc_lib = None
_dec_lib = None
_libs_tried = False


def _load_system_brotli():
    """Bind the system libbrotli (full RFC 7932 incl. the static
    dictionary) when present; the pure-Python subset below is the
    fallback."""
    global _enc_lib, _dec_lib, _libs_tried
    if _libs_tried:
        return
    _libs_tried = True
    for name in ("brotlienc", "libbrotlienc.so.1"):
        try:
            path = ctypes.util.find_library(name) or name
            _enc_lib = ctypes.CDLL(path)
            break
        except OSError:
            continue
    for name in ("brotlidec", "libbrotlidec.so.1"):
        try:
            path = ctypes.util.find_library(name) or name
            _dec_lib = ctypes.CDLL(path)
            break
        except OSError:
            continue


def brotli_compress(data: bytes, quality: int = 9) -> bytes:
    """Full Brotli compression via the system library; store-mode
    fallback when unavailable."""
    _load_system_brotli()
    if _enc_lib is None:
        return brotli_store(data)
    max_size = len(data) + (len(data) >> 2) + 1024
    out = ctypes.create_string_buffer(max_size)
    out_size = ctypes.c_size_t(max_size)
    ok = _enc_lib.BrotliEncoderCompress(
        ctypes.c_int(quality), ctypes.c_int(22), ctypes.c_int(0),
        ctypes.c_size_t(len(data)), data, ctypes.byref(out_size), out)
    if not ok:
        return brotli_store(data)
    return out.raw[:out_size.value]


def brotli_decompress(data: bytes, max_output: int = 1 << 30) -> bytes:
    """Full Brotli decode via the system library; falls back to the
    pure-Python subset decoder."""
    _load_system_brotli()
    if _dec_lib is None:
        return brotli_decode(data, max_output)
    size = max(1024, 4 * len(data))
    while size <= max_output:
        out = ctypes.create_string_buffer(size)
        out_size = ctypes.c_size_t(size)
        rc = _dec_lib.BrotliDecoderDecompress(
            ctypes.c_size_t(len(data)), data, ctypes.byref(out_size), out)
        if rc == 1:  # BROTLI_DECODER_RESULT_SUCCESS
            return out.raw[:out_size.value]
        if rc == 0 and size < max_output:  # error: maybe buffer too small
            size *= 8
            continue
        break
    raise JXLError("brotli: stream failed to decode")


class _BitReader:
    """Brotli LSB-first bit reader."""

    __slots__ = ("data", "pos", "buf", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.buf = 0
        self.nbits = 0

    def read(self, n: int) -> int:
        while self.nbits < n:
            if self.pos >= len(self.data):
                raise JXLError("brotli: truncated stream")
            self.buf |= self.data[self.pos] << self.nbits
            self.pos += 1
            self.nbits += 8
        v = self.buf & ((1 << n) - 1)
        self.buf >>= n
        self.nbits -= n
        return v

    def align_byte(self):
        drop = self.nbits % 8
        if drop:
            if self.buf & ((1 << drop) - 1):
                raise JXLError("brotli: nonzero padding")
            self.buf >>= drop
            self.nbits -= drop

    def read_bytes(self, n: int) -> bytes:
        self.align_byte()
        out = bytearray()
        while self.nbits >= 8 and n > 0:
            out.append(self.buf & 0xFF)
            self.buf >>= 8
            self.nbits -= 8
            n -= 1
        if n:
            if self.pos + n > len(self.data):
                raise JXLError("brotli: truncated uncompressed block")
            out += self.data[self.pos:self.pos + n]
            self.pos += n
        return bytes(out)


class _Huffman:
    """Canonical prefix decoder (bit-by-bit; metadata blobs are small)."""

    __slots__ = ("map", "max_len", "single")

    def __init__(self, lengths):
        self.single = None
        nz = [(s, l) for s, l in enumerate(lengths) if l > 0]
        if not nz:
            raise JXLError("brotli: prefix code with no symbols")
        if len(nz) == 1:
            self.single = nz[0][0]
            self.map = {}
            self.max_len = 0
            return
        # canonical code assignment (RFC 7932 3.2): sort by (length, symbol)
        self.map = {}
        code = 0
        self.max_len = max(l for _, l in nz)
        kept = sorted(nz, key=lambda t: (t[1], t[0]))
        prev_len = kept[0][1]
        for sym, ln in kept:
            code <<= (ln - prev_len)
            prev_len = ln
            self.map[(ln, code)] = sym
            code += 1

    def read(self, br: _BitReader) -> int:
        if self.single is not None:
            return self.single
        code = 0
        for ln in range(1, self.max_len + 1):
            code = (code << 1) | br.read(1)
            sym = self.map.get((ln, code))
            if sym is not None:
                return sym
        raise JXLError("brotli: invalid prefix code word")


_CL_ORDER = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# code lengths of the code-length code (RFC 7932 3.5)
_CL_CODE = {  # value bits read -> (nbits, symbol-length)
    0: (2, 0), 7: (4, 1), 3: (3, 2), 2: (2, 3), 1: (2, 4), 15: (4, 5),
}


def _read_cl_symbol(br: _BitReader) -> int:
    """Fixed code for code-length alphabet: lengths 2,4,3,2,2,4 for
    values 0,1,2,3,4,5."""
    v = br.read(2)
    if v == 0:
        return 0
    if v == 1:
        return 4
    if v == 2:
        return 3
    # v == 3: read more
    v |= br.read(1) << 2
    if v == 3:
        return 2
    # v == 7: one more bit
    v |= br.read(1) << 3
    return 1 if v == 7 else 5


def _read_prefix_code(br: _BitReader, alphabet_size: int) -> _Huffman:
    """RFC 7932 3.4/3.5."""
    hskip = br.read(2)
    if hskip == 1:  # simple code
        nsym = br.read(2) + 1
        bits = max(1, (alphabet_size - 1).bit_length())
        syms = [br.read(bits) for _ in range(nsym)]
        if any(s >= alphabet_size for s in syms):
            raise JXLError("brotli: simple-code symbol out of alphabet")
        if len(set(syms)) != nsym:
            raise JXLError("brotli: duplicate symbols in simple code")
        lengths = [0] * alphabet_size
        if nsym == 1:
            lengths[syms[0]] = 1
            h = _Huffman(lengths)
            h.single = syms[0]
            return h
        if nsym == 2:
            lengths[syms[0]] = lengths[syms[1]] = 1
        elif nsym == 3:
            lengths[syms[0]] = 1
            lengths[syms[1]] = lengths[syms[2]] = 2
        else:
            tree_select = br.read(1)
            if tree_select:
                lengths[syms[0]] = 1
                lengths[syms[1]] = 2
                lengths[syms[2]] = lengths[syms[3]] = 3
            else:
                for s in syms:
                    lengths[s] = 2
        return _Huffman(lengths)
    # complex code
    cl_lengths = [0] * 18
    space = 32
    num_codes = 0
    for i in range(hskip, 18):
        ln = _read_cl_symbol(br)
        cl_lengths[_CL_ORDER[i]] = ln
        if ln:
            space -= 32 >> ln
            num_codes += 1
            if space <= 0:
                break
    if num_codes == 1:
        # degenerate: the single code length applies to... the alphabet
        pass
    cl_huff = _Huffman(cl_lengths)
    lengths = [0] * alphabet_size
    symbol = 0
    prev_nonzero = 8
    space = 32768
    prev_repeat = 0
    prev_sym = -1
    while symbol < alphabet_size and space > 0:
        ln = cl_huff.read(br)
        if ln < 16:
            lengths[symbol] = ln
            symbol += 1
            if ln:
                prev_nonzero = ln
                space -= 32768 >> ln
            prev_repeat = 0
            prev_sym = ln
        elif ln == 16:
            extra = br.read(2)
            if prev_sym == 16 and prev_repeat:
                new_repeat = 4 * (prev_repeat - 2) + extra + 3
                delta = new_repeat - prev_repeat
            else:
                prev_repeat = 0
                new_repeat = extra + 3
                delta = new_repeat
            for _ in range(delta):
                if symbol >= alphabet_size:
                    raise JXLError("brotli: repeat overflows alphabet")
                lengths[symbol] = prev_nonzero
                symbol += 1
                space -= 32768 >> prev_nonzero
            prev_repeat = new_repeat
            prev_sym = 16
        else:  # 17: repeat zero
            extra = br.read(3)
            if prev_sym == 17 and prev_repeat:
                new_repeat = 8 * (prev_repeat - 2) + extra + 3
                delta = new_repeat - prev_repeat
            else:
                prev_repeat = 0
                new_repeat = extra + 3
                delta = new_repeat
            symbol += delta
            prev_repeat = new_repeat
            prev_sym = 17
    if symbol > alphabet_size:
        raise JXLError("brotli: code lengths overflow alphabet")
    return _Huffman(lengths)


def _read_varlen_nbltypes(br: _BitReader) -> int:
    """RFC 7932 6: 1 + few bits."""
    if not br.read(1):
        return 1
    v = br.read(3)
    if v == 0:
        return 2
    return (1 << v) + 1 + br.read(v)


# insert-and-copy length codes (RFC 7932 5)
_INSERT_BASE = (0, 1, 2, 3, 4, 5, 6, 8, 10, 14, 18, 26, 34, 50, 66, 98, 130,
                194, 322, 578, 1090, 2114, 6210, 22594)
_INSERT_EXTRA = (0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9,
                 10, 12, 14, 24)
_COPY_BASE = (2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 18, 22, 30, 38, 54, 70,
              102, 134, 198, 326, 582, 1094, 2118)
_COPY_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7,
               8, 9, 10, 24)
# cell mapping (RFC table in 5): cell index -> (insert code offset,
# copy code offset, implicit distance-0 flag)
# RFC 7932 section 5: 11 ranges of 64 insert-and-copy codes
_IC_CELLS = (
    (0, 0, True), (0, 8, True),
    (0, 0, False), (0, 8, False), (8, 0, False), (8, 8, False),
    (0, 16, False), (16, 0, False), (8, 16, False), (16, 8, False),
    (16, 16, False),
)
_BLOCK_COUNT_BASE = (1, 5, 9, 13, 17, 25, 33, 41, 49, 65, 81, 97, 113, 145,
                     177, 209, 241, 305, 369, 497, 753, 1265, 2289, 4337,
                     8433, 16625)
_BLOCK_COUNT_EXTRA = (2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6,
                      7, 8, 9, 10, 11, 12, 13, 24)


def _decode_ic(sym: int, br: _BitReader):
    cell = sym >> 6
    ins_off, cp_off, dist0 = _IC_CELLS[cell]
    low = sym & 63
    ins_code = ins_off + (low >> 3)
    cp_code = cp_off + (low & 7)
    ins = _INSERT_BASE[ins_code] + br.read(_INSERT_EXTRA[ins_code])
    cp = _COPY_BASE[cp_code] + br.read(_COPY_EXTRA[cp_code])
    return ins, cp, dist0


def _read_block_count(br: _BitReader, huff: _Huffman) -> int:
    sym = huff.read(br)
    return _BLOCK_COUNT_BASE[sym] + br.read(_BLOCK_COUNT_EXTRA[sym])


def _read_context_map(br: _BitReader, num_trees: int, size: int):
    """RFC 7932 7.3 (with optional RLE of zeros and MTF)."""
    if num_trees == 1:
        return [0] * size
    use_rle = br.read(1)
    rle_max = br.read(4) + 1 if use_rle else 0
    huff = _read_prefix_code(br, num_trees + rle_max)
    cmap = []
    while len(cmap) < size:
        sym = huff.read(br)
        if sym == 0:
            cmap.append(0)
        elif sym <= rle_max:
            cmap.extend([0] * ((1 << sym) + br.read(sym)))
        else:
            cmap.append(sym - rle_max)
    if len(cmap) != size:
        raise JXLError("brotli: context map overflow")
    if br.read(1):  # inverse MTF
        mtf = list(range(256))
        for i, v in enumerate(cmap):
            val = mtf.pop(v)
            mtf.insert(0, val)
            cmap[i] = val
    return cmap


def brotli_decode(data: bytes, max_output: int = 1 << 30) -> bytes:
    """Decode a Brotli stream (no static-dictionary references)."""
    br = _BitReader(data)
    wbits_code = br.read(1)
    if wbits_code == 0:
        wbits = 16
    else:
        n = br.read(3)
        if n != 0:
            wbits = 17 + n
        else:
            n = br.read(3)
            if n == 0:
                wbits = 17
            elif n == 1:
                raise JXLError("brotli: invalid WBITS")
            else:
                wbits = 8 + n
    window = (1 << wbits) - 16
    out = bytearray()
    dist_cache = [4, 11, 15, 16]  # RFC 7932 4: initial ring
    islast = False
    while not islast:
        islast = bool(br.read(1))
        if islast and br.read(1):  # ISLASTEMPTY
            break
        mnibbles = br.read(2)
        if mnibbles == 3:
            # metadata block
            if br.read(1):
                raise JXLError("brotli: reserved bit set")
            mskipbytes = br.read(2)
            mskiplen = 0
            for i in range(mskipbytes):
                b = br.read(8)
                if i + 1 == mskipbytes and mskipbytes > 1 and b == 0:
                    raise JXLError("brotli: invalid MSKIPLEN")
                mskiplen |= b << (8 * i)
            if mskipbytes:
                mskiplen += 1
            br.read_bytes(mskiplen)
            continue
        mlen = br.read(4 * (mnibbles + 4)) + 1
        if len(out) + mlen > max_output:
            raise JXLError("brotli: output too large")
        if not islast and br.read(1):  # ISUNCOMPRESSED
            out += br.read_bytes(mlen)
            continue
        # --- compressed meta-block
        nbl = []
        btype_huff = []
        bcount_huff = []
        btype = [0, 0, 0]
        btype_prev = [1, 1, 1]
        bcount = [1 << 28, 1 << 28, 1 << 28]
        for cat in range(3):
            n = _read_varlen_nbltypes(br)
            nbl.append(n)
            if n >= 2:
                th = _read_prefix_code(br, n + 2)
                ch = _read_prefix_code(br, 26)
                btype_huff.append(th)
                bcount_huff.append(ch)
                bcount[cat] = _read_block_count(br, ch)
            else:
                btype_huff.append(None)
                bcount_huff.append(None)

        def switch_block(cat):
            sym = btype_huff[cat].read(br)
            if sym == 0:
                new = btype_prev[cat]
            elif sym == 1:
                new = (btype[cat] + 1) % nbl[cat]
            else:
                new = sym - 2
            btype_prev[cat] = btype[cat]
            btype[cat] = new
            bcount[cat] = _read_block_count(br, bcount_huff[cat])

        npostfix = br.read(2)
        ndirect = br.read(4) << npostfix
        cmodes = [br.read(2) for _ in range(nbl[0])]
        ntrees_l = _read_varlen_nbltypes(br)
        cmap_l = _read_context_map(br, ntrees_l, 64 * nbl[0])
        ntrees_d = _read_varlen_nbltypes(br)
        cmap_d = _read_context_map(br, ntrees_d, 4 * nbl[1])
        if ntrees_l > 1:
            raise JXLError(
                "brotli: literal context modeling (NTREES_L > 1) not "
                "supported by this subset decoder")
        lit_huff = [_read_prefix_code(br, 256) for _ in range(ntrees_l)]
        ic_huff = [_read_prefix_code(br, 704) for _ in range(nbl[1])]
        ndist_alpha = 16 + ndirect + (48 << npostfix)
        dist_huff = [_read_prefix_code(br, ndist_alpha)
                     for _ in range(ntrees_d)]
        produced = 0
        while produced < mlen:
            if bcount[1] == 0:
                switch_block(1)
            bcount[1] -= 1
            ic_sym = ic_huff[btype[1]].read(br)
            ins, cp, dist0 = _decode_ic(ic_sym, br)
            if produced + ins > mlen:
                raise JXLError("brotli: insert length exceeds MLEN")
            for _ in range(ins):
                if bcount[0] == 0:
                    switch_block(0)
                bcount[0] -= 1
                out.append(lit_huff[0].read(br))
                produced += 1
            if produced >= mlen:
                break  # copy part of the last command is ignored
            if dist0:
                distance = dist_cache[0]
            else:
                if bcount[2] == 0:
                    switch_block(2)
                bcount[2] -= 1
                dctx = 3 if cp > 4 else cp - 2
                dsym = dist_huff[cmap_d[4 * btype[2] + dctx]].read(br)
                if dsym < 16:
                    ref = dist_cache[dsym & 3] if dsym < 4 else \
                        dist_cache[0 if dsym < 10 else 1]
                    delta = (0, 0, 0, 0, -1, 1, -2, 2, -3, 3,
                             -1, 1, -2, 2, -3, 3)[dsym]
                    distance = ref + delta
                    if distance <= 0:
                        raise JXLError("brotli: invalid cached distance")
                elif dsym < 16 + ndirect:
                    distance = dsym - 16 + 1
                else:
                    dcode = dsym - ndirect - 16
                    pf_mask = (1 << npostfix) - 1
                    postfix = dcode & pf_mask
                    hcode = dcode >> npostfix
                    nbits = 1 + (hcode >> 1)
                    offset = ((2 + (hcode & 1)) << nbits) - 4
                    dextra = br.read(nbits)
                    distance = (((offset + dextra) << npostfix)
                                + postfix + ndirect + 1)
                if dsym != 0:
                    dist_cache = [distance] + dist_cache[:3]
            max_dist = min(len(out), window)
            if distance > max_dist:
                raise JXLError(
                    "brotli: static dictionary reference (dictionary "
                    "not embedded in this subset decoder)")
            if produced + cp > mlen:
                raise JXLError("brotli: copy length exceeds MLEN")
            for _ in range(cp):
                out.append(out[-distance])
                produced += 1
    return bytes(out)


def brotli_store(data: bytes) -> bytes:
    """Spec-compliant Brotli writer: uncompressed meta-blocks only
    (RFC 7932 9.1 stored mode). Any Brotli decoder reads this."""
    out = bytearray()
    # WBITS = 16: single 0 bit
    bits = []

    def put(n, v):
        for i in range(n):
            bits.append((v >> i) & 1)

    put(1, 0)  # wbits 16
    pos = 0
    n = len(data)
    if n == 0:
        put(1, 1)  # ISLAST
        put(1, 1)  # ISLASTEMPTY
    while pos < n:
        chunk = min(n - pos, 1 << 24)
        last_chunk = pos + chunk >= n
        put(1, 0)  # ISLAST=0 (uncompressed blocks require ISLAST=0)
        nibbles = max(4, ((chunk - 1).bit_length() + 3) // 4)
        if nibbles > 6:
            raise JXLError("brotli: block too large")
        put(2, nibbles - 4)
        put(4 * nibbles, chunk - 1)
        put(1, 1)  # ISUNCOMPRESSED
        # byte-align, then raw bytes
        while len(bits) % 8:
            bits.append(0)
        # flush bits to bytes
        for i in range(0, len(bits), 8):
            byte = 0
            for j, bit in enumerate(bits[i:i + 8]):
                byte |= bit << j
            out.append(byte)
        bits = []
        out += data[pos:pos + chunk]
        pos += chunk
        if last_chunk:
            put(1, 1)  # ISLAST
            put(1, 1)  # ISLASTEMPTY
    while len(bits) % 8:
        bits.append(0)
    for i in range(0, len(bits), 8):
        byte = 0
        for j, bit in enumerate(bits[i:i + 8]):
            byte |= bit << j
        out.append(byte)
    return bytes(out)
