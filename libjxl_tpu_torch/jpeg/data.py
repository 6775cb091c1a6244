"""Baseline JPEG parser: markers, tables, entropy-coded coefficients.

Structured model of a JPEG file in the spirit of jpeg::JPEGData
(lib/jxl/jpeg/jpeg_data.h:167): everything needed to re-serialize the
file bit-exactly (enc_jpeg_data_reader.cc analog). Baseline sequential
(SOF0/SOF1) with Huffman coding; restart markers supported.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from ..base.status import JXLError

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)


@dataclass
class HuffmanTable:
    table_class: int  # 0 = DC, 1 = AC
    table_id: int
    counts: list      # 16 entries
    values: list

    def build_decoder(self):
        """-> dict (length, code) -> value (MSB-first canonical)."""
        table = {}
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(self.counts[length - 1]):
                table[(length, code)] = self.values[k]
                code += 1
                k += 1
            code <<= 1
        return table

    def build_encoder(self):
        """-> dict value -> (length, code)."""
        out = {}
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(self.counts[length - 1]):
                out[self.values[k]] = (length, code)
                code += 1
                k += 1
            code <<= 1
        return out


@dataclass
class Component:
    comp_id: int
    h_samp: int
    v_samp: int
    quant_idx: int
    dc_table: int = 0
    ac_table: int = 0
    width_in_blocks: int = 0
    height_in_blocks: int = 0
    coeffs: np.ndarray = None  # (hb, wb, 64) int16, natural (zigzag) order


@dataclass
class ScanMeta:
    """One SOS: spectral band, refinement shift, encoder quirks
    (jpeg_data.h JPEGScanInfo analog)."""
    components: list = field(default_factory=list)  # Component refs
    Ss: int = 0
    Se: int = 63
    Ah: int = 0
    Al: int = 0
    reset_points: list = field(default_factory=list)
    extra_zero_runs: list = field(default_factory=list)  # (block_idx, n)


@dataclass
class JPEGData:
    width: int = 0
    height: int = 0
    precision: int = 8
    progressive: bool = False
    components: list = field(default_factory=list)
    quant: dict = field(default_factory=dict)      # id -> 64 ints (zigzag)
    quant_order: list = field(default_factory=list)
    huffman: list = field(default_factory=list)
    markers: list = field(default_factory=list)    # (marker, payload) pre-SOS
    restart_interval: int = 0
    scan_components: list = field(default_factory=list)
    scans: list = field(default_factory=list)      # ScanMeta per SOS
    eob_padding_bits: str = ""
    rst_padding: list = field(default_factory=list)  # bits in stream order
    trailing: bytes = b""

    @property
    def padding_in_order(self) -> list:
        """All discarded padding-bit strings in stream order (restart
        alignments and scan-final bytes interleaved as encountered)."""
        return list(self.rst_padding) + [self.eob_padding_bits]


class _BitReaderJPEG:
    """MSB-first entropy-coded segment reader with 0xFF00 unstuffing."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.bitbuf = 0
        self.nbits = 0
        self.marker = None

    def _next_byte(self) -> int:
        b = self.data[self.pos]
        if b == 0xFF:
            nxt = self.data[self.pos + 1]
            if nxt == 0x00:
                self.pos += 2
                return 0xFF
            self.marker = nxt
            return None
        self.pos += 1
        return b

    def read_bit(self) -> int:
        if self.nbits == 0:
            b = self._next_byte()
            if b is None:
                return 0  # past-marker padding bits read as... spec: error
            self.bitbuf = b
            self.nbits = 8
        self.nbits -= 1
        return (self.bitbuf >> self.nbits) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def align_and_check_rst(self):
        # record the discarded padding bits (jbrd needs them verbatim)
        pad = ""
        if self.nbits:
            pad = format(self.bitbuf & ((1 << self.nbits) - 1),
                         f"0{self.nbits}b")
        self.nbits = 0
        if (self.data[self.pos] == 0xFF
                and 0xD0 <= self.data[self.pos + 1] <= 0xD7):
            self.pos += 2
        return pad


def _decode_huff(br: _BitReaderJPEG, table: dict) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | br.read_bit()
        v = table.get((length, code))
        if v is not None:
            return v
    raise JXLError("invalid JPEG huffman code")


def _extend(v: int, n: int) -> int:
    """JPEG signed magnitude extension."""
    if n == 0:
        return 0
    return v if v >= (1 << (n - 1)) else v - (1 << n) + 1


# Total coefficient-buffer budget for untrusted input: 8M blocks of
# 64 int16 = 1 GiB (the reference bounds decode memory the same way,
# lib/jxl/dec_frame.cc memory limits).
_MAX_TOTAL_BLOCKS = 8 << 20


def parse_jpeg(data: bytes) -> JPEGData:
    """Parse JPEG bytes; raises JXLError on any malformed input
    (enc_jpeg_data_reader.cc error stance)."""
    try:
        return _parse_jpeg_impl(data)
    except JXLError:
        raise
    except (IndexError, KeyError, ValueError, struct.error,
            OverflowError, MemoryError) as e:
        raise JXLError(f"malformed JPEG: {type(e).__name__}: {e}") from e


def _parse_jpeg_impl(data: bytes) -> JPEGData:
    if data[:2] != b"\xff\xd8":
        raise JXLError("not a JPEG (no SOI)")
    jd = JPEGData()
    pos = 2
    sof_seen = False
    while pos + 1 < len(data):
        if data[pos] != 0xFF:
            raise JXLError("JPEG marker expected")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            jd.trailing = data[pos:]
            # the last scan's final-byte padding is the EOB padding;
            # everything before it stays in stream order
            if jd.rst_padding:
                jd.eob_padding_bits = jd.rst_padding.pop()
            return jd
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > len(data):
            raise JXLError("JPEG truncated in marker length")
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        if length < 2 or pos + length > len(data):
            raise JXLError("JPEG marker overruns the file")
        payload = data[pos + 2:pos + length]
        if marker == 0xDB:  # DQT
            p = 0
            while p < len(payload):
                pq = payload[p] >> 4
                tq = payload[p] & 15
                p += 1
                if pq > 1 or tq > 3:
                    raise JXLError("invalid DQT header")
                if p + (128 if pq else 64) > len(payload):
                    raise JXLError("DQT table truncated")
                if pq:
                    vals = list(struct.unpack(f">64H", payload[p:p + 128]))
                    p += 128
                else:
                    vals = list(payload[p:p + 64])
                    p += 64
                jd.quant[tq] = vals
                jd.quant_order.append((tq, pq))
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1 baseline, SOF2 prog.
            if sof_seen:
                raise JXLError("duplicate SOF")
            jd.precision = payload[0]
            if jd.precision != 8:
                raise JXLError(
                    f"unsupported JPEG precision {jd.precision}")
            jd.progressive = marker == 0xC2
            jd.height, jd.width = struct.unpack(">HH", payload[1:5])
            if jd.height == 0 or jd.width == 0:
                raise JXLError("invalid JPEG dimensions")
            ncomp = payload[5]
            if not 1 <= ncomp <= 4 or len(payload) < 6 + 3 * ncomp:
                raise JXLError("invalid SOF component list")
            for i in range(ncomp):
                cid, hv, tq = payload[6 + 3 * i:9 + 3 * i]
                hs, vs = hv >> 4, hv & 15
                if not (1 <= hs <= 4 and 1 <= vs <= 4) or tq > 3:
                    raise JXLError("invalid SOF sampling/table fields")
                jd.components.append(Component(cid, hs, vs, tq))
            hmax = max(c.h_samp for c in jd.components)
            vmax = max(c.v_samp for c in jd.components)
            mcux0 = -(-jd.width // (8 * hmax))
            mcuy0 = -(-jd.height // (8 * vmax))
            total_blocks = sum(
                mcux0 * c.h_samp * mcuy0 * c.v_samp
                for c in jd.components)
            if total_blocks > _MAX_TOTAL_BLOCKS:
                raise JXLError("JPEG coefficient buffers exceed the "
                               "memory budget")
            sof_seen = True
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(payload):
                if p + 17 > len(payload):
                    raise JXLError("DHT truncated")
                tc = payload[p] >> 4
                th = payload[p] & 15
                if tc > 1 or th > 3:
                    raise JXLError("invalid DHT header")
                counts = list(payload[p + 1:p + 17])
                n = sum(counts)
                if n > 256 or p + 17 + n > len(payload):
                    raise JXLError("DHT values truncated")
                values = list(payload[p + 17:p + 17 + n])
                jd.huffman.append(HuffmanTable(tc, th, counts, values))
                p += 17 + n
        elif marker == 0xDD:  # DRI
            if len(payload) < 2:
                raise JXLError("DRI truncated")
            jd.restart_interval = struct.unpack(">H", payload[:2])[0]
        elif marker == 0xDA:  # SOS
            if not sof_seen:
                raise JXLError("SOS before SOF")
            ns = payload[0]
            if ns < 1 or len(payload) < 4 + 2 * ns:
                raise JXLError("invalid SOS header")
            jd.scan_components = []
            scan = ScanMeta()
            for i in range(ns):
                cs, tables = payload[1 + 2 * i:3 + 2 * i]
                for comp in jd.components:
                    if comp.comp_id == cs:
                        comp.dc_table = tables >> 4
                        comp.ac_table = tables & 15
                        jd.scan_components.append(comp)
                        scan.components.append(comp)
                        break
                else:
                    raise JXLError("SOS references unknown component")
            scan.Ss = payload[1 + 2 * ns]
            scan.Se = payload[2 + 2 * ns]
            scan.Ah = payload[3 + 2 * ns] >> 4
            scan.Al = payload[3 + 2 * ns] & 15
            if not jd.progressive:
                scan.Ss, scan.Se, scan.Ah, scan.Al = 0, 63, 0, 0
            jd.scans.append(scan)
            pos += length
            pos = _decode_scan(jd, data, pos, scan)
            continue
        else:
            jd.markers.append((marker, payload))
        pos += length
    raise JXLError("JPEG truncated (no EOI)")


def _decode_scan(jd: JPEGData, data: bytes, pos: int, scan: ScanMeta) -> int:
    """Decode one entropy-coded scan body: sequential, or any of the four
    progressive kinds (DC/AC first/refinement). Mirrors ProcessScan +
    DecodeDCTBlock + RefineDCTBlock (enc_jpeg_data_reader.cc:536-875),
    including the reset-point / extra-zero-run bookkeeping the writer
    needs for bit-exact reconstruction."""
    hmax = max(c.h_samp for c in jd.components)
    vmax = max(c.v_samp for c in jd.components)
    if jd.components[0].coeffs is None:
        mcux0 = -(-jd.width // (8 * hmax))
        mcuy0 = -(-jd.height // (8 * vmax))
        for c in jd.components:
            c.width_in_blocks = mcux0 * c.h_samp
            c.height_in_blocks = mcuy0 * c.v_samp
            c.coeffs = np.zeros((c.height_in_blocks, c.width_in_blocks, 64),
                                dtype=np.int16)
    interleaved = len(scan.components) > 1
    if interleaved:
        mcux = -(-jd.width // (8 * hmax))
        mcuy = -(-jd.height // (8 * vmax))
    else:
        c0 = scan.components[0]
        mcux = -(-(jd.width * c0.h_samp) // (8 * hmax))
        mcuy = -(-(jd.height * c0.v_samp) // (8 * vmax))
    if not jd.progressive:
        # baseline sequential scans decode in C (same bit semantics,
        # incl. restart/final padding and extra-zero-run capture)
        from ..native_ext import get_lib, jpeg_decode_scan_native

        specs = [((c.v_samp if interleaved else 1),
                  (c.h_samp if interleaved else 1))
                 for c in scan.components]
        res = jpeg_decode_scan_native(
            get_lib(), data, pos, scan.components, specs, jd.huffman,
            mcux, mcuy, jd.restart_interval)
        if res is not None:
            new_pos, per_comp, pads, fin, ezr = res
            for c, arr in zip(scan.components, per_comp):
                c.coeffs[...] = arr
            jd.rst_padding.extend(pads)
            jd.rst_padding.append(fin)
            scan.extra_zero_runs = ezr
            return new_pos
    dec_tables = {}
    for t in jd.huffman:
        dec_tables[(t.table_class, t.table_id)] = t.build_decoder()
    br = _BitReaderJPEG(data, pos)
    preds = {id(c): 0 for c in jd.components}
    Ss, Se, Ah, Al = scan.Ss, scan.Se, scan.Ah, scan.Al
    Am = 1 << Al
    eobrun_allowed = Ss > 0
    eobrun = -1  # -1 = fresh start (no eob state yet)
    block_scan_index = 0
    mcu_count = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if (jd.restart_interval and mcu_count
                    and mcu_count % jd.restart_interval == 0):
                jd.rst_padding.append(br.align_and_check_rst())
                for c in jd.components:
                    preds[id(c)] = 0
                if eobrun > 0:
                    raise JXLError("JPEG end-of-block run too long")
                eobrun = -1
            for c in scan.components:
                nby = c.v_samp if interleaved else 1
                nbx = c.h_samp if interleaved else 1
                for by in range(nby):
                    for bx in range(nbx):
                        block = c.coeffs[my * nby + by, mx * nbx + bx]
                        reset_state = False
                        num_zero_runs = 0
                        if Ah == 0:
                            k = Ss
                            if Ss == 0:
                                dc_tab = dec_tables[(0, c.dc_table)]
                                s = _decode_huff(br, dc_tab)
                                diff = _extend(br.read_bits(s), s)
                                preds[id(c)] += diff
                                block[0] = preds[id(c)] * Am
                                k = 1
                            if k <= Se:
                                if eobrun > 0:
                                    eobrun -= 1
                                else:
                                    ac_tab = dec_tables[(1, c.ac_table)]
                                    while k <= Se:
                                        rs = _decode_huff(br, ac_tab)
                                        r, s = rs >> 4, rs & 15
                                        if s > 0:
                                            k += r
                                            if k > Se:
                                                raise JXLError(
                                                    "JPEG AC band overflow")
                                            block[k] = _extend(
                                                br.read_bits(s), s) * Am
                                            num_zero_runs = 0
                                            k += 1
                                        elif r == 15:
                                            k += 16
                                            num_zero_runs += 1
                                        else:
                                            if (eobrun_allowed and k == Ss
                                                    and eobrun == 0):
                                                reset_state = True
                                            eobrun = 1 << r
                                            if r > 0:
                                                if not eobrun_allowed:
                                                    raise JXLError(
                                                        "EOB run crosses DC")
                                                eobrun += br.read_bits(r)
                                            break
                                    eobrun -= 1
                        else:
                            # refinement pass (RefineDCTBlock)
                            k = Ss
                            if Ss == 0:
                                if br.read_bit():
                                    block[0] = int(block[0]) | Am
                                k = 1
                            if k <= Se:
                                p1, m1 = Am, -Am
                                in_zero_run = False
                                ac_tab = dec_tables[(1, c.ac_table)]
                                if eobrun <= 0:
                                    while k <= Se:
                                        rs = _decode_huff(br, ac_tab)
                                        r, s = rs >> 4, rs & 15
                                        newval = 0
                                        if s:
                                            if s != 1:
                                                raise JXLError(
                                                    "bad refinement symbol")
                                            newval = p1 if br.read_bit() \
                                                else m1
                                            in_zero_run = False
                                        else:
                                            if r != 15:
                                                if (eobrun_allowed
                                                        and k == Ss
                                                        and eobrun == 0):
                                                    reset_state = True
                                                eobrun = 1 << r
                                                if r > 0:
                                                    if not eobrun_allowed:
                                                        raise JXLError(
                                                            "EOB crosses DC")
                                                    eobrun += br.read_bits(r)
                                                break
                                            in_zero_run = True
                                        while k <= Se:
                                            cur = int(block[k])
                                            if cur != 0:
                                                if br.read_bit():
                                                    if (cur & p1) == 0:
                                                        cur += (p1 if cur >= 0
                                                                else m1)
                                                    block[k] = cur
                                            else:
                                                r -= 1
                                                if r < 0:
                                                    break
                                            k += 1
                                        if s and k <= Se:
                                            block[k] = newval
                                        elif s:
                                            raise JXLError(
                                                "JPEG AC band overflow")
                                        k += 1
                                if in_zero_run:
                                    raise JXLError(
                                        "extra zero run before EOB")
                                if eobrun > 0:
                                    while k <= Se:
                                        cur = int(block[k])
                                        if cur != 0:
                                            if br.read_bit():
                                                if (cur & p1) == 0:
                                                    cur += (p1 if cur >= 0
                                                            else m1)
                                                block[k] = cur
                                        k += 1
                                eobrun -= 1
                        if reset_state:
                            scan.reset_points.append(block_scan_index)
                        if num_zero_runs > 0:
                            scan.extra_zero_runs.append(
                                (block_scan_index, num_zero_runs))
                        block_scan_index += 1
            mcu_count += 1
    if eobrun > 0:
        raise JXLError("JPEG end-of-block run too long")
    # record padding bits of the final partial byte for bit-exact rewrite
    pad = ""
    if br.nbits:
        pad = format(br.bitbuf & ((1 << br.nbits) - 1), f"0{br.nbits}b")
        br.nbits = 0
    jd.rst_padding.append(pad)
    # skip to the next marker
    p = br.pos
    while p + 1 < len(data) and not (data[p] == 0xFF and data[p + 1] != 0x00
                                     and not 0xD0 <= data[p + 1] <= 0xD7):
        p += 1
    return p
