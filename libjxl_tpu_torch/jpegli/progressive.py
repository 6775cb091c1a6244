"""Progressive JPEG emission for the jpegli encoder.

Implements the reference's default progressive scan scripts
(SetDefaultScanScript, lib/jpegli/encode.cc:107-151):

  level 1: DC; AC 1-63 at Al=1; AC refinement to Al=0
  level 2: DC; AC 1-2; AC 3-63 at Al=2; two refinement passes

Each scan gets its own two-pass optimal Huffman table (count, then
emit — the symbol stream of a progressive scan depends on EOB-run
state, so the counting pass replays the exact emission logic with a
recording table).  Block encoders are shared with the bit-exact JPEG
reconstruction path (jpeg/jbrd.py).
"""

from __future__ import annotations

import struct

import numpy as np

from ..jpeg.data import HuffmanTable
from ..jpeg.jbrd import (_DCTCodingState, _encode_block_progressive,
                         _encode_block_refinement)
from ..jpeg.writer import _BitWriterJPEG


class _CountingTable:
    """Stands in for an encoder table during the histogram pass."""

    def __init__(self):
        self.freq = np.zeros(256, dtype=np.int64)

    def __getitem__(self, sym):
        self.freq[sym] += 1
        return (0, 0)


class _NullWriter:
    out = b""
    nbits = 0

    def write_bits(self, value, n):
        pass


def scan_script(level: int, ncomp: int, interleave_dc: bool):
    """-> list of (Ss, Se, Ah, Al, comp_indices)."""
    if level == 1:
        spec = [(0, 0, 0, 0, interleave_dc), (1, 63, 0, 1, False),
                (1, 63, 1, 0, False)]
    else:
        spec = [(0, 0, 0, 0, interleave_dc), (1, 2, 0, 0, False),
                (3, 63, 0, 2, False), (3, 63, 2, 1, False),
                (3, 63, 1, 0, False)]
    scans = []
    for ss, se, ah, al, inter in spec:
        if inter:
            scans.append((ss, se, ah, al, list(range(ncomp))))
        else:
            for c in range(ncomp):
                scans.append((ss, se, ah, al, [c]))
    return scans


def _spec_blocks(width, height, c, hmax, vmax):
    """Per-spec block counts of a component in a NON-interleaved scan
    (T.81 A.2.2: component size rounded up to blocks, no MCU padding)."""
    cw = -(-width * c.h_samp // hmax)
    ch = -(-height * c.v_samp // vmax)
    return -(-ch // 8), -(-cw // 8)


def _emit_scan(comps, scan, width, height, hmax, vmax, dc_tabs,
               ac_tabs, bw):
    """Run one scan's block loop against the given tables/writer.
    dc_tabs/ac_tabs: per scan-component encoder tables (or None)."""
    ss, se, ah, al, comp_idx = scan
    interleaved = len(comp_idx) > 1
    state = _DCTCodingState()
    preds = [0] * len(comps)
    refinement = ah > 0
    if interleaved:
        base = comps[comp_idx[0]]
        mcux = base.coeffs.shape[1] // base.h_samp
        mcuy = base.coeffs.shape[0] // base.v_samp
        for my in range(mcuy):
            for mx in range(mcux):
                for sci, ci in enumerate(comp_idx):
                    c = comps[ci]
                    for iy in range(c.v_samp):
                        for ix in range(c.h_samp):
                            block = c.coeffs[my * c.v_samp + iy,
                                             mx * c.h_samp + ix]
                            if refinement:
                                _encode_block_refinement(
                                    block, ac_tabs[sci], ss, se, al,
                                    state, bw)
                            else:
                                _encode_block_progressive(
                                    block, dc_tabs[sci], ac_tabs[sci],
                                    ss, se, al, 0, state, preds, ci, bw)
    else:
        c = comps[comp_idx[0]]
        nby, nbx = _spec_blocks(width, height, c, hmax, vmax)
        for by in range(nby):
            for bx in range(nbx):
                block = c.coeffs[by, bx]
                if refinement:
                    _encode_block_refinement(block, ac_tabs[0], ss, se,
                                             al, state, bw)
                else:
                    _encode_block_progressive(block, dc_tabs[0],
                                              ac_tabs[0], ss, se, al, 0,
                                              state, preds, comp_idx[0],
                                              bw)
    state.flush(bw)


def write_progressive_jpeg(width, height, comps, quant_zigzag,
                           markers, level: int) -> bytes:
    """Assemble a progressive (SOF2) JPEG with per-scan optimal
    Huffman tables.  comps: jpeg.data.Component list with zigzag
    coeffs; quant_zigzag: dict id -> 64 ints."""
    from .encode import _optimal_huffman

    hmax = max(c.h_samp for c in comps)
    vmax = max(c.v_samp for c in comps)
    interleave_dc = hmax == 1 and vmax == 1
    scans = scan_script(level, len(comps), interleave_dc)

    out = bytearray(b"\xff\xd8")
    for marker, payload in markers:
        out += bytes([0xFF, marker])
        out += struct.pack(">H", len(payload) + 2)
        out += payload
    for tq, vals in quant_zigzag.items():
        payload = bytes([0 << 4 | tq]) + bytes(vals)
        out += b"\xff\xdb" + struct.pack(">H", len(payload) + 2) + payload
    sof = bytes([8]) + struct.pack(">HH", height, width)
    sof += bytes([len(comps)])
    for c in comps:
        sof += bytes([c.comp_id, (c.h_samp << 4) | c.v_samp, c.quant_idx])
    out += b"\xff\xc2" + struct.pack(">H", len(sof) + 2) + sof

    for scan in scans:
        ss, se, ah, al, comp_idx = scan
        nsc = len(comp_idx)
        refinement_dc_only = ah > 0 and ss == 0 and se == 0
        # pass 1: count symbols with recording tables
        dc_cnt = [_CountingTable() for _ in range(nsc)]
        ac_cnt = [_CountingTable() for _ in range(nsc)]
        _emit_scan(comps, scan, width, height, hmax, vmax, dc_cnt,
                   ac_cnt, _NullWriter())
        # build per-scan tables; slot = scan-component index
        tables = []
        dc_tabs = [None] * nsc
        ac_tabs = [None] * nsc
        for i in range(nsc):
            if ss == 0 and ah == 0 and dc_cnt[i].freq.sum():
                t = _optimal_huffman(dc_cnt[i].freq, 0, i)
                tables.append(t)
                dc_tabs[i] = t.build_encoder()
            if not refinement_dc_only and ac_cnt[i].freq.sum():
                t = _optimal_huffman(ac_cnt[i].freq, 1, i)
                tables.append(t)
                ac_tabs[i] = t.build_encoder()
        if tables:
            for t in tables:
                payload = bytes([(t.table_class << 4) | t.table_id])
                payload += bytes(t.counts) + bytes(t.values)
                out += b"\xff\xc4" + struct.pack(
                    ">H", len(payload) + 2) + payload
        sos = bytes([nsc])
        for i, ci in enumerate(comp_idx):
            sos += bytes([comps[ci].comp_id, (i << 4) | i])
        sos += bytes([ss, se, (ah << 4) | al])
        out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
        bw = _BitWriterJPEG()
        _emit_scan(comps, scan, width, height, hmax, vmax, dc_tabs,
                   ac_tabs, bw)
        bw.flush()
        out += bw.out
    out += b"\xff\xd9"
    return bytes(out)
