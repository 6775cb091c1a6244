"""JPEG re-serialization from JPEGData (dec_jpeg_data_writer.cc analog).

Writes markers, tables, and the Huffman-coded scan; with the tables and
coefficients from parse_jpeg the output is byte-identical to the input for
baseline files (padding bits preserved).
"""

from __future__ import annotations

import struct

import numpy as np

from .data import JPEGData


class _BitWriterJPEG:
    def __init__(self):
        self.out = bytearray()
        self.bitbuf = 0
        self.nbits = 0

    def write_bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bitbuf = (self.bitbuf << 1) | ((value >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.bitbuf)
                if self.bitbuf == 0xFF:
                    self.out.append(0x00)  # byte stuffing
                self.bitbuf = 0
                self.nbits = 0

    def flush(self, padding: str = "") -> None:
        if self.nbits:
            pad = 8 - self.nbits
            if padding and len(padding) == pad:
                bits = int(padding, 2)
            else:
                bits = (1 << pad) - 1  # conventional 1-padding
            self.write_bits(bits, pad)


def _csize(v: int) -> int:
    return int(v).bit_length() if v > 0 else int(-v).bit_length()


def write_jpeg(jd: JPEGData) -> bytes:
    out = bytearray(b"\xff\xd8")
    for marker, payload in jd.markers:
        out += bytes([0xFF, marker])
        out += struct.pack(">H", len(payload) + 2)
        out += payload
    # DQT (in original declaration order)
    for tq, pq in jd.quant_order:
        vals = jd.quant[tq]
        payload = bytes([pq << 4 | tq])
        if pq:
            payload += struct.pack(">64H", *vals)
        else:
            payload += bytes(vals)
        out += b"\xff\xdb" + struct.pack(">H", len(payload) + 2) + payload
    # SOF0
    sof = bytes([jd.precision]) + struct.pack(">HH", jd.height, jd.width)
    sof += bytes([len(jd.components)])
    for c in jd.components:
        sof += bytes([c.comp_id, (c.h_samp << 4) | c.v_samp, c.quant_idx])
    out += b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof
    # DHT
    for t in jd.huffman:
        payload = bytes([(t.table_class << 4) | t.table_id])
        payload += bytes(t.counts) + bytes(t.values)
        out += b"\xff\xc4" + struct.pack(">H", len(payload) + 2) + payload
    if jd.restart_interval:
        out += b"\xff\xdd" + struct.pack(">HH", 4, jd.restart_interval)
    # SOS
    sos = bytes([len(jd.scan_components)])
    for c in jd.scan_components:
        sos += bytes([c.comp_id, (c.dc_table << 4) | c.ac_table])
    sos += bytes([0, 63, 0])
    out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
    # scan
    enc_tables = {}
    for t in jd.huffman:
        enc_tables[(t.table_class, t.table_id)] = t.build_encoder()
    hmax = max(c.h_samp for c in jd.components)
    vmax = max(c.v_samp for c in jd.components)
    mcux = -(-jd.width // (8 * hmax))
    mcuy = -(-jd.height // (8 * vmax))
    # native hot loop (same bytes: conventional 1-padding applies)
    if not jd.eob_padding_bits or set(jd.eob_padding_bits) == {"1"}:
        from ..native_ext import get_lib, jpegli_scan_native

        scan = jpegli_scan_native(get_lib(), jd.scan_components,
                                  enc_tables, mcux, mcuy,
                                  jd.restart_interval)
        if scan is not None:
            out += scan
            out += b"\xff\xd9"
            out += jd.trailing
            return bytes(out)
    bw = _BitWriterJPEG()
    preds = {id(c): 0 for c in jd.components}
    mcu_count = 0
    rst = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if (jd.restart_interval and mcu_count
                    and mcu_count % jd.restart_interval == 0):
                bw.flush()
                bw.out += bytes([0xFF, 0xD0 + (rst & 7)])
                rst += 1
                for c in jd.components:
                    preds[id(c)] = 0
            for c in jd.scan_components:
                dc_tab = enc_tables[(0, c.dc_table)]
                ac_tab = enc_tables[(1, c.ac_table)]
                for by in range(c.v_samp):
                    for bx in range(c.h_samp):
                        block = c.coeffs[my * c.v_samp + by,
                                         mx * c.h_samp + bx]
                        diff = int(block[0]) - preds[id(c)]
                        preds[id(c)] = int(block[0])
                        s = _csize(diff)
                        ln, code = dc_tab[s]
                        bw.write_bits(code, ln)
                        if s:
                            v = diff if diff >= 0 else diff + (1 << s) - 1
                            bw.write_bits(v, s)
                        k = 1
                        run = 0
                        last_nz = 0
                        nz = np.nonzero(block[1:])[0]
                        last_nz = (nz[-1] + 1) if len(nz) else 0
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
                        if last_nz != 63:
                            ln, code = ac_tab[0x00]
                            bw.write_bits(code, ln)
            mcu_count += 1
    bw.flush(jd.eob_padding_bits)
    out += bw.out
    out += b"\xff\xd9"
    out += jd.trailing
    return bytes(out)
