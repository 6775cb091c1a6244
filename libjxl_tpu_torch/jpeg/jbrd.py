"""Reference-format JPEG reconstruction data (the `jbrd` box payload).

Faithful reimplementation of the JPEGData bundle serialization
(lib/jxl/jpeg/jpeg_data.cc VisitFields) and its EncodeJPEGData wrapper
(lib/jxl/jpeg/enc_jpeg_data.cc:314): a Fields-coded structural description
of the original JPEG followed by a Brotli stream carrying the verbatim
APP/COM/inter-marker/tail bytes. Combined with the DCT coefficients from
the VarDCT frame this reproduces the source JPEG bit-exactly — and because
it *is* the reference format, streams interop with libjxl both ways.

Writer side mirrors dec_jpeg_data_writer.cc (marker replay, restart
markers, recorded padding bits, extra zero runs).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from ..io.fields import Bits, BitsOffset, U32Enc, Val, u32_read, u32_write
from .data import ZIGZAG, JPEGData

# AppMarkerType (jpeg_data.h)
APP_UNKNOWN, APP_ICC, APP_EXIF, APP_XMP = 0, 1, 2, 3

_APPTYPE_ENC = U32Enc(Val(0), Val(1), BitsOffset(1, 2), BitsOffset(2, 4))
_NUMQ_ENC = U32Enc(Val(1), Val(2), Val(3), Val(4))
_NUMC_ENC = U32Enc(Val(1), Val(2), Val(3), Val(4))
_NUMHUFF_ENC = U32Enc(Val(4), BitsOffset(3, 2), BitsOffset(4, 10),
                      BitsOffset(6, 26))
_COUNT_ENC = U32Enc(Val(0), Val(1), BitsOffset(3, 2), Bits(8))
_VALUE_ENC = U32Enc(Bits(2), BitsOffset(2, 4), BitsOffset(4, 8),
                    BitsOffset(8, 1))
_NUMSC_ENC = U32Enc(Val(1), Val(2), Val(3), Val(4))
_LASTPASS_ENC = U32Enc(Val(0), Val(1), Val(2), BitsOffset(3, 3))
_NUMRESET_ENC = U32Enc(Val(0), BitsOffset(2, 1), BitsOffset(4, 4),
                       BitsOffset(16, 20))
_BLOCKIDX_ENC = U32Enc(Val(0), BitsOffset(3, 1), BitsOffset(5, 9),
                       BitsOffset(28, 41))
_NUMZRUN_ENC = U32Enc(Val(1), BitsOffset(2, 2), BitsOffset(4, 5),
                      BitsOffset(8, 20))
_TAIL_ENC = U32Enc(Val(0), BitsOffset(8, 1), BitsOffset(16, 257),
                   BitsOffset(22, 65793))


@dataclass
class JbrdQuant:
    precision: int = 0
    index: int = 0
    is_last: bool = True
    values: list = None  # 64 ints, raster order as in JPEGQuantTable.values


@dataclass
class JbrdHuff:
    slot_id: int = 0       # (is_ac << 4) | id
    counts: list = None    # 17 entries (counts[0] unused, as reference)
    values: list = None    # num_symbols entries, last == 256 sentinel
    is_last: bool = True


@dataclass
class JbrdScanComponent:
    comp_idx: int = 0
    ac_tbl_idx: int = 0
    dc_tbl_idx: int = 0


@dataclass
class JbrdScan:
    Ss: int = 0
    Se: int = 63
    Ah: int = 0
    Al: int = 0
    components: list = field(default_factory=list)
    last_needed_pass: int = 0
    reset_points: list = field(default_factory=list)
    extra_zero_runs: list = field(default_factory=list)  # (block_idx, nruns)


@dataclass
class JbrdData:
    """Mirror of jpeg::JPEGData restricted to what the bundle carries."""
    marker_order: list = field(default_factory=list)  # ints, ends with 0xD9
    app_data: list = field(default_factory=list)      # full segments w/ marker
    app_marker_type: list = field(default_factory=list)
    com_data: list = field(default_factory=list)
    quant: list = field(default_factory=list)         # JbrdQuant
    component_ids: list = field(default_factory=list)
    comp_quant_idx: list = field(default_factory=list)
    huffman_code: list = field(default_factory=list)  # JbrdHuff
    scan_info: list = field(default_factory=list)     # JbrdScan
    restart_interval: int = 0
    inter_marker_data: list = field(default_factory=list)
    tail_data: bytes = b""
    padding_bits: list = None  # list of 0/1, or None = all-ones padding


# ---------------------------------------------------------------------------
# Bundle serialization (jpeg_data.cc VisitFields)

def write_jbrd_bundle(jb: JbrdData, w: BitWriter) -> None:
    is_gray = len(jb.component_ids) == 1
    w.write(1, int(is_gray))
    if not jb.marker_order or jb.marker_order[-1] != 0xD9:
        raise JXLError("marker order must end with EOI")
    has_dri = False
    n_inter = 0
    for m in jb.marker_order:
        w.write(6, m - 0xC0)
        if m == 0xDD:
            has_dri = True
        if m == 0xFF:
            n_inter += 1
    for i, app in enumerate(jb.app_data):
        u32_write(_APPTYPE_ENC, jb.app_marker_type[i], w)
        w.write(16, len(app) - 1)
    for com in jb.com_data:
        w.write(16, len(com) - 1)
    u32_write(_NUMQ_ENC, len(jb.quant), w)
    for q in jb.quant:
        w.write(1, q.precision)
        w.write(2, q.index)
        w.write(1, int(q.is_last))
    ids = jb.component_ids
    if ids == [1]:
        ctype = 0
    elif ids == [1, 2, 3]:
        ctype = 1
    elif ids == [ord("R"), ord("G"), ord("B")]:
        ctype = 2
    else:
        ctype = 3
    w.write(2, ctype)
    if ctype == 3:
        u32_write(_NUMC_ENC, len(ids), w)
        for cid in ids:
            w.write(8, cid)
    for qi in jb.comp_quant_idx:
        w.write(2, qi)
    u32_write(_NUMHUFF_ENC, len(jb.huffman_code), w)
    for hc in jb.huffman_code:
        w.write(1, int((hc.slot_id >> 4) != 0))
        w.write(2, hc.slot_id & 0xF)
        w.write(1, int(hc.is_last))
        for i in range(17):
            u32_write(_COUNT_ENC, hc.counts[i], w)
        for v in hc.values:
            u32_write(_VALUE_ENC, v, w)
        if hc.values[-1] != 256:
            raise JXLError("huffman values must end with the 256 sentinel")
    for sc in jb.scan_info:
        u32_write(_NUMSC_ENC, len(sc.components), w)
        w.write(6, sc.Ss)
        w.write(6, sc.Se)
        w.write(4, sc.Al)
        w.write(4, sc.Ah)
        for c in sc.components:
            w.write(2, c.comp_idx)
            w.write(2, c.ac_tbl_idx)
            w.write(2, c.dc_tbl_idx)
        u32_write(_LASTPASS_ENC, sc.last_needed_pass, w)
    if has_dri:
        w.write(16, jb.restart_interval)
    for sc in jb.scan_info:
        u32_write(_NUMRESET_ENC, len(sc.reset_points), w)
        last = -1
        for bi in sorted(sc.reset_points):
            u32_write(_BLOCKIDX_ENC, bi - (last + 1), w)
            last = bi
        u32_write(_NUMRESET_ENC, len(sc.extra_zero_runs), w)
        last = -1
        for bi, nruns in sc.extra_zero_runs:
            u32_write(_NUMZRUN_ENC, nruns, w)
            u32_write(_BLOCKIDX_ENC, bi - (last + 1), w)
            last = bi
    if len(jb.inter_marker_data) != n_inter:
        raise JXLError("inter-marker data count mismatch")
    for data in jb.inter_marker_data:
        w.write(16, len(data))
    u32_write(_TAIL_ENC, len(jb.tail_data), w)
    has_zero_pad = jb.padding_bits is not None
    w.write(1, int(has_zero_pad))
    if has_zero_pad:
        w.write(24, len(jb.padding_bits))
        for b in jb.padding_bits:
            w.write(1, b)


def read_jbrd_bundle(r: BitReader) -> JbrdData:
    jb = JbrdData()
    is_gray = bool(r.read_bits(1))
    num_comp_guess = 1 if is_gray else 3
    n_app = n_com = n_scan = n_inter = 0
    has_dri = False
    while True:
        m = r.read_bits(6) + 0xC0
        jb.marker_order.append(m)
        if (m & 0xF0) == 0xE0:
            n_app += 1
        if m == 0xFE:
            n_com += 1
        if m == 0xDA:
            n_scan += 1
        if m == 0xFF:
            n_inter += 1
        if m == 0xDD:
            has_dri = True
        if m == 0xD9:
            break
        if len(jb.marker_order) > 16384:
            raise JXLError("too many markers")
    app_lens = []
    for _ in range(n_app):
        jb.app_marker_type.append(u32_read(_APPTYPE_ENC, r))
        app_lens.append(r.read_bits(16) + 1)
    com_lens = [r.read_bits(16) + 1 for _ in range(n_com)]
    nq = u32_read(_NUMQ_ENC, r)
    if nq == 4:
        raise JXLError("invalid number of quant tables")
    for _ in range(nq):
        q = JbrdQuant()
        q.precision = r.read_bits(1)
        q.index = r.read_bits(2)
        q.is_last = bool(r.read_bits(1))
        q.values = [0] * 64
        jb.quant.append(q)
    ctype = r.read_bits(2)
    if ctype == 0:
        jb.component_ids = [1]
    elif ctype == 1:
        jb.component_ids = [1, 2, 3]
    elif ctype == 2:
        jb.component_ids = [ord("R"), ord("G"), ord("B")]
    else:
        n = u32_read(_NUMC_ENC, r)
        jb.component_ids = [r.read_bits(8) for _ in range(n)]
    del num_comp_guess
    jb.comp_quant_idx = [r.read_bits(2) for _ in jb.component_ids]
    nh = u32_read(_NUMHUFF_ENC, r)
    for _ in range(nh):
        hc = JbrdHuff()
        is_ac = r.read_bits(1)
        hid = r.read_bits(2)
        hc.slot_id = (is_ac << 4) | hid
        hc.is_last = bool(r.read_bits(1))
        hc.counts = [u32_read(_COUNT_ENC, r) for _ in range(17)]
        nsym = sum(hc.counts)
        if nsym < 1 or nsym > 258:
            raise JXLError("bad huffman symbol count")
        hc.values = [u32_read(_VALUE_ENC, r) for _ in range(nsym)]
        if hc.values[-1] != 256:
            raise JXLError("missing huffman EOI sentinel")
        jb.huffman_code.append(hc)
    for _ in range(n_scan):
        sc = JbrdScan()
        n = u32_read(_NUMSC_ENC, r)
        sc.Ss = r.read_bits(6)
        sc.Se = r.read_bits(6)
        sc.Al = r.read_bits(4)
        sc.Ah = r.read_bits(4)
        for _ in range(n):
            c = JbrdScanComponent()
            c.comp_idx = r.read_bits(2)
            c.ac_tbl_idx = r.read_bits(2)
            c.dc_tbl_idx = r.read_bits(2)
            sc.components.append(c)
        sc.last_needed_pass = u32_read(_LASTPASS_ENC, r)
        jb.scan_info.append(sc)
    if has_dri:
        jb.restart_interval = r.read_bits(16)
    for sc in jb.scan_info:
        nr = u32_read(_NUMRESET_ENC, r)
        last = -1
        for _ in range(nr):
            d = u32_read(_BLOCKIDX_ENC, r)
            last = last + 1 + d
            sc.reset_points.append(last)
        nz = u32_read(_NUMRESET_ENC, r)
        last = -1
        for _ in range(nz):
            nruns = u32_read(_NUMZRUN_ENC, r)
            d = u32_read(_BLOCKIDX_ENC, r)
            last = last + 1 + d
            sc.extra_zero_runs.append((last, nruns))
    inter_lens = [r.read_bits(16) for _ in range(n_inter)]
    tail_len = u32_read(_TAIL_ENC, r)
    if r.read_bits(1):
        nbit = r.read_bits(24)
        jb.padding_bits = [r.read_bits(1) for _ in range(nbit)]
    # stash byte lengths for the brotli part
    jb._app_lens = app_lens
    jb._com_lens = com_lens
    jb._inter_lens = inter_lens
    jb._tail_len = tail_len
    return jb


# ---------------------------------------------------------------------------
# EncodeJPEGData / DecodeJPEGData wrapper (bundle ∥ brotli blob)

def encode_jbrd(jb: JbrdData) -> bytes:
    from ..io.brotli import brotli_compress

    w = BitWriter()
    write_jbrd_bundle(jb, w)
    head = w.get_bytes()
    blob = bytearray()
    for i, app in enumerate(jb.app_data):
        if jb.app_marker_type[i] == APP_UNKNOWN:
            blob += app
    for com in jb.com_data:
        blob += com
    for data in jb.inter_marker_data:
        blob += data
    blob += jb.tail_data
    return head + brotli_compress(bytes(blob))


def decode_jbrd(payload: bytes) -> JbrdData:
    from ..io.brotli import brotli_decompress

    r = BitReader(payload)
    jb = read_jbrd_bundle(r)
    r.jump_to_byte_boundary()
    blob = brotli_decompress(payload[r.total_bits_consumed() // 8:])
    pos = 0
    num_icc = 0
    _ICC_TAG = b"ICC_PROFILE\x00"
    _EXIF_TAG = b"Exif\x00\x00"
    _XMP_TAG = b"http://ns.adobe.com/xap/1.0/\x00"
    for i, ln in enumerate(jb._app_lens):
        t = jb.app_marker_type[i]
        if t == APP_UNKNOWN:
            jb.app_data.append(bytes(blob[pos:pos + ln]))
            pos += ln
            continue
        # typed markers: the header bytes are reconstructed here
        # (DecodeJPEGData, jpeg/dec_jpeg_data.cc:66-105); the payload is
        # filled from codestream/container metadata by set_*_app below.
        seg = bytearray(ln)
        size_m1 = ln - 1
        seg[1] = size_m1 >> 8
        seg[2] = size_m1 & 0xFF
        if t == APP_ICC:
            if ln < 17:
                raise JXLError("ICC markers must be at least 17 bytes")
            seg[0] = 0xE2
            seg[3:15] = _ICC_TAG
            num_icc += 1
            seg[15] = num_icc
        elif t == APP_EXIF:
            if ln < 3 + len(_EXIF_TAG):
                raise JXLError("incorrect Exif marker size")
            seg[0] = 0xE1
            seg[3:3 + len(_EXIF_TAG)] = _EXIF_TAG
        elif t == APP_XMP:
            if ln < 3 + len(_XMP_TAG):
                raise JXLError("incorrect XMP marker size")
            seg[0] = 0xE1
            seg[3:3 + len(_XMP_TAG)] = _XMP_TAG
        jb.app_data.append(seg)
    for i, t in enumerate(jb.app_marker_type):
        if t == APP_ICC:
            jb.app_data[i][16] = num_icc
    for ln in jb._com_lens:
        jb.com_data.append(bytes(blob[pos:pos + ln]))
        pos += ln
    for ln in jb._inter_lens:
        jb.inter_marker_data.append(bytes(blob[pos:pos + ln]))
        pos += ln
    jb.tail_data = bytes(blob[pos:pos + jb._tail_len])
    if len(jb.tail_data) != jb._tail_len:
        raise JXLError("jbrd tail data truncated")
    return jb


def fill_app_segments(jb: JbrdData, icc: bytes = None, exif: bytes = None,
                      xmp: bytes = None) -> None:
    """Fill typed APP marker payloads from codestream/container metadata
    (SetJPEGDataFromICC jpeg_data.cc:456-478; JxlToJpegDecoder::SetExif /
    SetXmp decode_to_jpeg.cc:142-180). Raises when a needed source is
    missing — a reconstructed JPEG must never carry zeroed segments."""
    icc_pos = 0
    for i, t in enumerate(jb.app_marker_type):
        seg = jb.app_data[i]
        if t == APP_ICC:
            ln = len(seg) - 17
            if icc is None or icc_pos + ln > len(icc):
                raise JXLError(
                    "jbrd: stream lacks the ICC profile bytes needed to "
                    "rebuild its APP2 ICC markers")
            seg[17:] = icc[icc_pos:icc_pos + ln]
            icc_pos += ln
        elif t == APP_EXIF:
            # the Exif box payload starts with a 4-byte TIFF offset that
            # is not part of the JPEG segment
            need = len(seg) - 9 + 4
            if exif is None or len(exif) != need:
                raise JXLError(
                    "jbrd: Exif APP1 marker needs a matching Exif box "
                    f"({need} bytes) to reconstruct")
            seg[9:] = exif[4:]
        elif t == APP_XMP:
            need = len(seg) - 3 - 29
            if xmp is None or len(xmp) != need:
                raise JXLError(
                    "jbrd: XMP APP1 marker needs a matching xml box "
                    f"({need} bytes) to reconstruct")
            seg[3 + 29:] = xmp
    if icc is not None and icc_pos not in (0, len(icc)):
        raise JXLError("jbrd: ICC profile longer than its APP markers")


# ---------------------------------------------------------------------------
# JPEG structure -> JbrdData (enc_jpeg_data_reader + DetectBlobs analog)

def jbrd_from_jpeg(data: bytes, jd: JPEGData) -> JbrdData:
    """Walk the raw JPEG once more to capture exact marker order and
    verbatim segments; entropy padding bits come from the parsed `jd`."""
    if data[:2] != b"\xff\xd8":
        raise JXLError("not a JPEG")
    jb = JbrdData()
    jb.restart_interval = jd.restart_interval
    pos = 2
    scan_idx = 0
    while pos < len(data):
        if data[pos] != 0xFF:
            # inter-marker garbage: signaled with the fake 0xFF marker
            start = pos
            while pos < len(data) and data[pos] != 0xFF:
                pos += 1
            jb.marker_order.append(0xFF)
            jb.inter_marker_data.append(data[start:pos])
            continue
        marker = data[pos + 1]
        if marker == 0xD9:
            jb.marker_order.append(0xD9)
            jb.tail_data = data[pos + 2:]
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        length = (data[pos + 2] << 8) | data[pos + 3]
        seg = data[pos + 1:pos + 2 + length]  # marker byte + len + payload
        jb.marker_order.append(marker)
        if (marker & 0xF0) == 0xE0:
            jb.app_data.append(seg)
            jb.app_marker_type.append(APP_UNKNOWN)
        elif marker == 0xFE:
            jb.com_data.append(seg)
        elif marker == 0xDA:
            sc = JbrdScan()
            payload = seg[3:]
            ns = payload[0]
            comp_index = {cid: i for i, cid in enumerate(
                c.comp_id for c in jd.components)}
            for i in range(ns):
                cs, tables = payload[1 + 2 * i:3 + 2 * i]
                c = JbrdScanComponent()
                c.comp_idx = comp_index[cs]
                c.dc_tbl_idx = tables >> 4
                c.ac_tbl_idx = tables & 15
                sc.components.append(c)
            sc.Ss, sc.Se = payload[1 + 2 * ns], payload[2 + 2 * ns]
            sc.Ah = payload[3 + 2 * ns] >> 4
            sc.Al = payload[3 + 2 * ns] & 15
            if scan_idx < len(jd.scans):
                sc.reset_points = list(jd.scans[scan_idx].reset_points)
                sc.extra_zero_runs = list(
                    jd.scans[scan_idx].extra_zero_runs)
            jb.scan_info.append(sc)
            scan_idx += 1
            # skip the entropy-coded body to the next marker
            pos += 2 + length
            while pos + 1 < len(data):
                if data[pos] == 0xFF and data[pos + 1] not in (0x00,) \
                        and not (0xD0 <= data[pos + 1] <= 0xD7):
                    break
                pos += 1
            continue
        pos += 2 + length
    else:
        raise JXLError("JPEG truncated")

    # quant tables, in declaration order with DQT-segment grouping
    # (quant_order entries within one DQT share a segment)
    seen = []
    for i, (tq, pq) in enumerate(jd.quant_order):
        q = JbrdQuant()
        q.precision = pq
        q.index = tq
        q.values = [0] * 64
        vals = jd.quant[tq]
        # jd.quant is zigzag DQT order; JPEGQuantTable.values is raster
        for k in range(64):
            q.values[ZIGZAG[k]] = vals[k]
        seen.append(q)
    # is_last: group per original DQT marker; conservative: every table is
    # its own marker unless the source had multi-table DQT segments.
    dqt_counts = _segment_table_counts(data, 0xDB)
    _assign_is_last(seen, dqt_counts)
    jb.quant = seen

    # component ids / quant indices
    jb.component_ids = [c.comp_id for c in jd.components]
    qidx_of = {q.index: i for i, q in enumerate(jb.quant)}
    jb.comp_quant_idx = [qidx_of[c.quant_idx] for c in jd.components]

    # huffman codes, DHT order with the 256 sentinel value appended
    hlist = []
    for t in jd.huffman:
        hc = JbrdHuff()
        hc.slot_id = (t.table_class << 4) | t.table_id
        counts = [0] + list(t.counts)
        values = list(t.values)
        # append the sentinel as an extra symbol of the deepest used level
        # (enc_jpeg_data_reader.cc:322-335)
        max_depth = 0
        for i in range(16, 0, -1):
            if counts[i] > 0:
                max_depth = i
                break
        max_depth = max(max_depth, 1)
        counts[max_depth] += 1
        hc.counts = counts
        values.append(256)
        hc.values = values
        hlist.append(hc)
    dht_counts = _segment_table_counts(data, 0xC4)
    _assign_is_last(hlist, dht_counts)
    jb.huffman_code = hlist

    # padding bits: all per-restart paddings then the final EOB padding
    bits = []
    nonstandard = False
    for pad in jd.padding_in_order:
        for ch in pad:
            b = 1 if ch == "1" else 0
            bits.append(b)
            if b == 0:
                nonstandard = True
    jb.padding_bits = bits if nonstandard else None
    return jb


def _segment_table_counts(data: bytes, marker: int) -> list:
    """Number of tables declared in each DQT/DHT segment, in order."""
    counts = []
    pos = 2
    while pos + 3 < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xD9:
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        length = (data[pos + 2] << 8) | data[pos + 3]
        if m == marker:
            payload = data[pos + 4:pos + 2 + length]
            n = 0
            p = 0
            while p < len(payload):
                if marker == 0xDB:
                    pq = payload[p] >> 4
                    p += 1 + (128 if pq else 64)
                else:  # DHT
                    cnt = sum(payload[p + 1:p + 17])
                    p += 17 + cnt
                n += 1
            counts.append(n)
        if m == 0xDA:
            pos += 2 + length
            while pos + 1 < len(data):
                if data[pos] == 0xFF and data[pos + 1] != 0x00 \
                        and not (0xD0 <= data[pos + 1] <= 0xD7):
                    break
                pos += 1
            continue
        pos += 2 + length
    return counts


def _assign_is_last(entries: list, seg_counts: list) -> None:
    i = 0
    for n in seg_counts:
        for j in range(n):
            if i < len(entries):
                entries[i].is_last = (j == n - 1)
                i += 1


# ---------------------------------------------------------------------------
# JbrdData + coefficients -> JPEG bytes (dec_jpeg_data_writer.cc analog)

class _PadBits:
    def __init__(self, bits):
        self.bits = bits
        self.pos = 0

    def take(self, n: int) -> int:
        if self.bits is None:
            return (1 << n) - 1
        v = 0
        for _ in range(n):
            if self.pos >= len(self.bits):
                raise JXLError("ran out of jbrd padding bits")
            v = (v << 1) | self.bits[self.pos]
            self.pos += 1
        return v


def jpeg_from_jbrd(jb: JbrdData, width: int, height: int,
                   components: list) -> bytes:
    """components: list of dicts {h_samp, v_samp, coeffs (hb, wb, 64)
    natural-order int arrays, width_in_blocks, height_in_blocks}."""
    from .writer import _BitWriterJPEG

    out = bytearray(b"\xff\xd8")
    app_i = com_i = dqt_i = dht_i = scan_i = inter_i = 0
    active_tables = {}  # slot -> encoder dict; DHT markers update in order
    pad = _PadBits(jb.padding_bits)
    is_progressive = any(m == 0xC2 for m in jb.marker_order)
    for marker in jb.marker_order:
        if (marker & 0xF0) == 0xE0:
            out += b"\xff" + bytes(jb.app_data[app_i])
            app_i += 1
        elif marker == 0xFE:
            out += b"\xff" + bytes(jb.com_data[com_i])
            com_i += 1
        elif marker == 0xFF:
            out += jb.inter_marker_data[inter_i]
            inter_i += 1
        elif marker == 0xDB:
            seg = bytearray()
            while True:
                q = jb.quant[dqt_i]
                dqt_i += 1
                seg.append((q.precision << 4) | q.index)
                for k in range(64):
                    v = q.values[ZIGZAG[k]]
                    if q.precision:
                        seg.append((v >> 8) & 0xFF)
                    seg.append(v & 0xFF)
                if q.is_last:
                    break
            out += b"\xff\xdb" + (len(seg) + 2).to_bytes(2, "big") + seg
        elif marker in (0xC0, 0xC1, 0xC2):
            seg = bytearray([8])
            seg += height.to_bytes(2, "big") + width.to_bytes(2, "big")
            seg.append(len(components))
            for i, c in enumerate(components):
                seg.append(jb.component_ids[i])
                seg.append((c["h_samp"] << 4) | c["v_samp"])
                seg.append(jb.quant[jb.comp_quant_idx[i]].index)
            out += bytes([0xFF, marker]) \
                + (len(seg) + 2).to_bytes(2, "big") + seg
        elif marker == 0xC4:
            seg = bytearray()
            while True:
                hc = jb.huffman_code[dht_i]
                dht_i += 1
                seg.append(hc.slot_id)
                counts = list(hc.counts[1:17])
                values = [v for v in hc.values if v != 256]
                # drop the sentinel from the deepest level
                for i in range(15, -1, -1):
                    if counts[i] > 0:
                        counts[i] -= 1
                        break
                seg += bytes(counts) + bytes(values)
                table = {}
                code = 0
                k = 0
                for length in range(1, 17):
                    for _ in range(counts[length - 1]):
                        table[values[k]] = (length, code)
                        code += 1
                        k += 1
                    code <<= 1
                active_tables[hc.slot_id] = table
                if hc.is_last:
                    break
            out += b"\xff\xc4" + (len(seg) + 2).to_bytes(2, "big") + seg
        elif marker == 0xDD:
            out += b"\xff\xdd\x00\x04" \
                + jb.restart_interval.to_bytes(2, "big")
        elif marker == 0xDA:
            sc = jb.scan_info[scan_i]
            scan_i += 1
            seg = bytearray([len(sc.components)])
            for c in sc.components:
                seg.append(jb.component_ids[c.comp_idx])
                seg.append((c.dc_tbl_idx << 4) | c.ac_tbl_idx)
            seg += bytes([sc.Ss, sc.Se, (sc.Ah << 4) | sc.Al])
            out += b"\xff\xda" + (len(seg) + 2).to_bytes(2, "big") + seg
            out += _encode_scan_body(jb, sc, components, pad, width, height,
                                     is_progressive, active_tables)
        elif marker == 0xD9:
            out += b"\xff\xd9" + jb.tail_data
        else:
            raise JXLError(f"unsupported marker 0x{marker:02x} in jbrd")
    return bytes(out)


class _DCTCodingState:
    """Deferred end-of-band state (dec_jpeg_data_writer.cc:186-204):
    EOB runs and refinement bits buffer until the next Flush."""

    __slots__ = ("eob_run", "cur_ac_tab", "refinement_bits")

    def __init__(self):
        self.eob_run = 0
        self.cur_ac_tab = None
        self.refinement_bits = []

    def flush(self, bw):
        if self.eob_run > 0:
            nbits = self.eob_run.bit_length() - 1
            ln, code = self.cur_ac_tab[nbits << 4]
            bw.write_bits(code, ln)
            if nbits > 0:
                bw.write_bits(self.eob_run & ((1 << nbits) - 1), nbits)
            self.eob_run = 0
        for b in self.refinement_bits:
            bw.write_bits(b, 1)
        self.refinement_bits = []

    def buffer_eob(self, ac_tab, new_bits, bw):
        if self.eob_run == 0:
            self.cur_ac_tab = ac_tab
        self.eob_run += 1
        if new_bits:
            self.refinement_bits.extend(new_bits)
        if self.eob_run == 0x7FFF:
            self.flush(bw)


def _encode_block_progressive(block, dc_tab, ac_tab, Ss, Se, Al,
                              num_zero_runs, state, preds, ci, bw):
    """EncodeDCTBlockProgressive (dec_jpeg_data_writer.cc:585-658)."""
    from .writer import _csize

    eob_run_allowed = Ss > 0
    if Ss == 0:
        temp2 = int(block[0]) >> Al
        diff = temp2 - preds[ci]
        preds[ci] = temp2
        s = _csize(diff)
        ln, code = dc_tab[s]
        bw.write_bits(code, ln)
        if s:
            v = diff if diff >= 0 else diff + (1 << s) - 1
            bw.write_bits(v, s)
        Ss = 1
    if Ss > Se:
        return
    r = 0
    for k in range(Ss, Se + 1):
        temp = int(block[k])
        if temp == 0:
            r += 1
            continue
        if temp < 0:
            temp = (-temp) >> Al
            temp2 = ~temp
        else:
            temp >>= Al
            temp2 = temp
        if temp == 0:
            r += 1
            continue
        state.flush(bw)
        while r > 15:
            ln, code = ac_tab[0xF0]
            bw.write_bits(code, ln)
            r -= 16
        nbits = temp.bit_length()
        ln, code = ac_tab[(r << 4) | nbits]
        bw.write_bits(code, ln)
        bw.write_bits(temp2 & ((1 << nbits) - 1), nbits)
        r = 0
    if num_zero_runs > 0:
        state.flush(bw)
        for _ in range(num_zero_runs):
            ln, code = ac_tab[0xF0]
            bw.write_bits(code, ln)
            r -= 16
    if r > 0:
        state.buffer_eob(ac_tab, None, bw)
        if not eob_run_allowed:
            state.flush(bw)


def _encode_block_refinement(block, ac_tab, Ss, Se, Al, state, bw):
    """EncodeRefinementBits (dec_jpeg_data_writer.cc:660-723)."""
    eob_run_allowed = Ss > 0
    if Ss == 0:
        bw.write_bits((int(block[0]) >> Al) & 1, 1)
        Ss = 1
    if Ss > Se:
        return
    abs_values = {}
    eob = 0
    for k in range(Ss, Se + 1):
        av = abs(int(block[k])) >> Al
        abs_values[k] = av
        if av == 1:
            eob = k
    r = 0
    refinement_bits = []
    for k in range(Ss, Se + 1):
        if abs_values[k] == 0:
            r += 1
            continue
        while r > 15 and k <= eob:
            state.flush(bw)
            ln, code = ac_tab[0xF0]
            bw.write_bits(code, ln)
            r -= 16
            for b in refinement_bits:
                bw.write_bits(b, 1)
            refinement_bits = []
        if abs_values[k] > 1:
            refinement_bits.append(abs_values[k] & 1)
            continue
        state.flush(bw)
        new_non_zero_bit = 0 if int(block[k]) < 0 else 1
        ln, code = ac_tab[(r << 4) | 1]
        bw.write_bits(code, ln)
        bw.write_bits(new_non_zero_bit, 1)
        for b in refinement_bits:
            bw.write_bits(b, 1)
        refinement_bits = []
        r = 0
    if r > 0 or refinement_bits:
        state.buffer_eob(ac_tab, refinement_bits, bw)
        if not eob_run_allowed:
            state.flush(bw)


def _encode_scan_body(jb: JbrdData, sc: JbrdScan, components: list,
                      pad: _PadBits, width: int, height: int,
                      is_progressive: bool = False,
                      active_tables: dict = None) -> bytes:
    from .writer import _BitWriterJPEG, _csize

    if active_tables is not None:
        enc_tables = active_tables
    else:
        # build encoder tables by slot (single-scan callers)
        enc_tables = {}
        for hc in jb.huffman_code:
            counts = list(hc.counts[1:17])
            values = [v for v in hc.values if v != 256]
            for i in range(15, -1, -1):
                if counts[i] > 0:
                    counts[i] -= 1
                    break
            table = {}
            code = 0
            k = 0
            for length in range(1, 17):
                for _ in range(counts[length - 1]):
                    table[values[k]] = (length, code)
                    code += 1
                    k += 1
                code <<= 1
            enc_tables[hc.slot_id] = table
    # MCU geometry (jpeg_data.cc CalculateMcuSize)
    interleaved = len(sc.components) > 1
    hmax = max(c["h_samp"] for c in components)
    vmax = max(c["v_samp"] for c in components)
    base = components[sc.components[0].comp_idx]
    h_group = 1 if interleaved else base["h_samp"]
    v_group = 1 if interleaved else base["v_samp"]
    mcux = -(-(width * h_group) // (8 * hmax))
    mcuy = -(-(height * v_group) // (8 * vmax))

    Ss = sc.Ss if is_progressive else 0
    Se = sc.Se if is_progressive else 63
    Ah = sc.Ah if is_progressive else 0
    Al = sc.Al if is_progressive else 0
    # EncodeScan mode selection (dec_jpeg_data_writer.cc:889-906)
    if Ah == 0 and Al == 0 and Ss == 0 and Se == 63:
        mode = 0
    elif Ah == 0:
        mode = 1
    else:
        mode = 2
    cstate = _DCTCodingState()
    bw = _BitWriterJPEG()
    ezr = {bi: n for bi, n in sc.extra_zero_runs}
    reset = set(sc.reset_points)
    restart_interval = jb.restart_interval
    restarts_to_go = restart_interval
    next_rst = 0
    preds = [0] * len(components)
    block_scan_index = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart_interval and restarts_to_go == 0:
                cstate.flush(bw)
                if bw.nbits:
                    bw.write_bits(pad.take(8 - bw.nbits), 8 - bw.nbits)
                bw.out += bytes([0xFF, 0xD0 + (next_rst & 7)])
                next_rst += 1
                restarts_to_go = restart_interval
                preds = [0] * len(components)
            for si in sc.components:
                c = components[si.comp_idx]
                dc_tab = enc_tables.get(si.dc_tbl_idx)
                ac_tab = enc_tables.get(0x10 | si.ac_tbl_idx)
                nby = c["v_samp"] if interleaved else 1
                nbx = c["h_samp"] if interleaved else 1
                for iy in range(nby):
                    for ix in range(nbx):
                        by = my * nby + iy
                        bx = mx * nbx + ix
                        block = c["coeffs"][by, bx]
                        if block_scan_index in reset:
                            cstate.flush(bw)
                        nzr = ezr.get(block_scan_index, 0)
                        block_scan_index += 1
                        if mode == 1:
                            _encode_block_progressive(
                                block, dc_tab, ac_tab, Ss, Se, Al, nzr,
                                cstate, preds, si.comp_idx, bw)
                            continue
                        if mode == 2:
                            _encode_block_refinement(
                                block, ac_tab, Ss, Se, Al, cstate, bw)
                            continue
                        diff = int(block[0]) - preds[si.comp_idx]
                        preds[si.comp_idx] = int(block[0])
                        s = _csize(diff)
                        ln, code = dc_tab[s]
                        bw.write_bits(code, ln)
                        if s:
                            v = diff if diff >= 0 else diff + (1 << s) - 1
                            bw.write_bits(v, s)
                        run = 0
                        nz = np.nonzero(block[1:])[0]
                        last_nz = (nz[-1] + 1) if len(nz) else 0
                        k = 1
                        while k <= last_nz:
                            v = int(block[k])
                            if v == 0:
                                run += 1
                                k += 1
                                continue
                            while run > 15:
                                ln, code = ac_tab[0xF0]
                                bw.write_bits(code, ln)
                                run -= 16
                            s = _csize(v)
                            ln, code = ac_tab[(run << 4) | s]
                            bw.write_bits(code, ln)
                            vv = v if v >= 0 else v + (1 << s) - 1
                            bw.write_bits(vv, s)
                            run = 0
                            k += 1
                        # EncodeDCTBlockSequential tail: trailing-zero run,
                        # then signaled extra zero runs, then EOB if r > 0
                        run = 63 - last_nz
                        for _ in range(nzr):
                            ln, code = ac_tab[0xF0]
                            bw.write_bits(code, ln)
                            run -= 16
                        if run > 0:
                            ln, code = ac_tab[0x00]
                            bw.write_bits(code, ln)
            restarts_to_go -= 1
    cstate.flush(bw)
    if bw.nbits:
        bw.write_bits(pad.take(8 - bw.nbits), 8 - bw.nbits)
    return bytes(bw.out)
