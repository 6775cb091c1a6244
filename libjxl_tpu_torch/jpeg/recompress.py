"""Lossless JPEG recompression: re-code DCT coefficients with the modular
entropy coder, keep a metadata blob for bit-exact reconstruction.

This is the round-1 realization of the reference transcode path
(enc_frame.cc ComputeJPEGTranscodingData + jpeg/enc_jpeg_data.h): the
Huffman-coded scan is replaced by rANS-coded, context-modeled residuals
(DC gradient-predicted; AC per coefficient-column), and all non-coefficient
bytes travel in a metadata box. Reconstruction re-emits the original file
byte-for-byte (tests assert equality). The box layout is framework-specific
pending full 18181-2 jbrd conformance.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from ..io.container import make_box, parse_boxes, CONTAINER_HEADER
from ..modular.codec import modular_decode, modular_encode
from ..modular.image import Channel, ModularImage
from ..modular.predict import P_GRADIENT
from ..modular.tree import make_fixed_tree
from .data import JPEGData, Component, HuffmanTable, parse_jpeg
from .writer import write_jpeg


def _meta_blob(jd: JPEGData) -> bytes:
    meta = {
        "width": jd.width, "height": jd.height, "precision": jd.precision,
        "restart_interval": jd.restart_interval,
        "eob_padding_bits": jd.eob_padding_bits,
        "quant_order": jd.quant_order,
        "quant": {str(k): v for k, v in jd.quant.items()},
        "huffman": [[t.table_class, t.table_id, t.counts, t.values]
                    for t in jd.huffman],
        "components": [[c.comp_id, c.h_samp, c.v_samp, c.quant_idx,
                        c.dc_table, c.ac_table, c.width_in_blocks,
                        c.height_in_blocks] for c in jd.components],
        "scan": [c.comp_id for c in jd.scan_components],
        "markers": [[m, p.hex()] for m, p in jd.markers],
        "trailing": jd.trailing.hex(),
    }
    return json.dumps(meta).encode()


def _meta_from_blob(blob: bytes) -> JPEGData:
    meta = json.loads(blob.decode())
    jd = JPEGData()
    jd.width = meta["width"]
    jd.height = meta["height"]
    jd.precision = meta["precision"]
    jd.restart_interval = meta["restart_interval"]
    jd.eob_padding_bits = meta["eob_padding_bits"]
    jd.quant_order = [tuple(x) for x in meta["quant_order"]]
    jd.quant = {int(k): v for k, v in meta["quant"].items()}
    jd.huffman = [HuffmanTable(*t) for t in meta["huffman"]]
    jd.components = [Component(*c) for c in meta["components"]]
    by_id = {c.comp_id: c for c in jd.components}
    jd.scan_components = [by_id[i] for i in meta["scan"]]
    jd.markers = [(m, bytes.fromhex(p)) for m, p in meta["markers"]]
    jd.trailing = bytes.fromhex(meta["trailing"])
    return jd


# --- AC token model: nzeros + zero-density contexts per component, exactly
# the VarDCT AC machinery (ac_context.h) applied to 8x8 JPEG blocks.
from ..entropy.decode import ANSSymbolReader, decode_histograms
from ..entropy.encode import Token, build_and_encode_histograms, write_tokens
from ..vardct.ctx import (
    NONZERO_BUCKETS,
    ZERO_DENSITY_CONTEXT_COUNT,
    zero_density_context,
)


def _nzero_ctx(comp: int, pred: int, ncomp: int) -> int:
    pred = min(pred, 64)
    ctx = pred if pred < 8 else 4 + pred // 2
    return ctx * ncomp + comp


def _ac_ctx_base(ncomp: int) -> int:
    return NONZERO_BUCKETS * ncomp


def _num_jpeg_contexts(ncomp: int) -> int:
    return NONZERO_BUCKETS * ncomp + ZERO_DENSITY_CONTEXT_COUNT * ncomp


def _tokenize_jpeg_ac(jd: JPEGData):
    ncomp = len(jd.components)
    tokens = []
    for ci, c in enumerate(jd.components):
        hb, wb = c.height_in_blocks, c.width_in_blocks
        co = c.coeffs
        nz_map = np.zeros((hb, wb), dtype=np.int32)
        histo_off = _ac_ctx_base(ncomp) + ZERO_DENSITY_CONTEXT_COUNT * ci
        for by in range(hb):
            for bx in range(wb):
                block = co[by, bx]
                nz = np.nonzero(block[1:])[0]
                nzeros = len(nz)
                if bx == 0:
                    pred = int(nz_map[by - 1, 0]) if by else 32
                elif by == 0:
                    pred = int(nz_map[0, bx - 1])
                else:
                    pred = (int(nz_map[by - 1, bx])
                            + int(nz_map[by, bx - 1]) + 1) // 2
                tokens.append(Token(_nzero_ctx(ci, pred, ncomp), nzeros))
                nz_map[by, bx] = nzeros
                prev = 0 if nzeros > 4 else 1
                k = 1
                rem = nzeros
                while k < 64 and rem:
                    v = int(block[k])
                    u = (v << 1) if v >= 0 else (-v * 2 - 1)
                    ctx = histo_off + zero_density_context(rem, k, 1, 0, prev)
                    tokens.append(Token(ctx, u))
                    prev = 1 if u else 0
                    rem -= prev
                    k += 1
    return tokens


def _decode_jpeg_ac(r: BitReader, jd: JPEGData) -> None:
    ncomp = len(jd.components)
    code, cmap = decode_histograms(r, _num_jpeg_contexts(ncomp))
    reader = ANSSymbolReader(code, r)
    for ci, c in enumerate(jd.components):
        hb, wb = c.height_in_blocks, c.width_in_blocks
        nz_map = np.zeros((hb, wb), dtype=np.int32)
        histo_off = _ac_ctx_base(ncomp) + ZERO_DENSITY_CONTEXT_COUNT * ci
        for by in range(hb):
            for bx in range(wb):
                block = c.coeffs[by, bx]
                if bx == 0:
                    pred = int(nz_map[by - 1, 0]) if by else 32
                elif by == 0:
                    pred = int(nz_map[0, bx - 1])
                else:
                    pred = (int(nz_map[by - 1, bx])
                            + int(nz_map[by, bx - 1]) + 1) // 2
                nzeros = reader.read_hybrid_uint(
                    _nzero_ctx(ci, pred, ncomp), r, cmap)
                nz_map[by, bx] = nzeros
                prev = 0 if nzeros > 4 else 1
                k = 1
                rem = nzeros
                while k < 64 and rem:
                    u = reader.read_hybrid_uint(
                        histo_off + zero_density_context(rem, k, 1, 0, prev),
                        r, cmap)
                    block[k] = (u >> 1) if (u & 1) == 0 else -((u + 1) >> 1)
                    prev = 1 if u else 0
                    rem -= prev
                    k += 1
    if not reader.check_final_state():
        raise JXLError("JPEG AC stream corrupt")


def recompress_jpeg(data: bytes) -> bytes:
    jd = parse_jpeg(data)
    # DC: modular (gradient-predicted per component)
    dc_img = ModularImage(1, 1, 16, 0)
    dc_img.channel = [
        Channel(c.width_in_blocks, c.height_in_blocks,
                data=c.coeffs[:, :, 0].astype(np.int32))
        for c in jd.components]
    w = BitWriter()
    modular_encode(dc_img, w, tree=make_fixed_tree(P_GRADIENT))
    # AC: VarDCT-style tokens
    tokens = _tokenize_jpeg_ac(jd)
    ncomp = len(jd.components)
    codes, cmap = build_and_encode_histograms(
        [tokens], _num_jpeg_contexts(ncomp), w)
    write_tokens(tokens, codes, cmap, w)
    coeff_stream = w.get_bytes()
    out = [CONTAINER_HEADER]
    # jbrd metadata is Brotli-compressed like the reference
    # (jpeg/enc_jpeg_data.h:26 EncodeJPEGData packs non-coeff bytes
    # with Brotli)
    from ..io.brotli import brotli_compress

    out.append(make_box(b"jbrd", b"\x01" + brotli_compress(_meta_blob(jd))))
    out.append(make_box(b"jxlc", coeff_stream))
    return b"".join(out)


def reconstruct_jpeg(container: bytes) -> bytes:
    if container[:12] != CONTAINER_HEADER[:12]:
        raise JXLError("not a recompressed-JPEG container")
    blob = None
    exif = xmp = None
    stream_parts = []
    for btype, payload, _ in parse_boxes(container[12:]):
        if btype == b"jbrd":
            blob = payload
        elif btype == b"jxlc":
            stream_parts.append(payload)
        elif btype == b"jxlp":
            stream_parts.append(payload[4:])  # strip the part index
        elif btype == b"Exif":
            exif = payload
        elif btype == b"xml ":
            xmp = payload
    if blob is None or not stream_parts:
        raise JXLError("missing jbrd/jxlc boxes")
    stream = b"".join(stream_parts)
    if blob[:1] not in (b"\x01", b"\x02"):
        # reference jbrd bundle (jpeg_data.cc VisitFields)
        from .jbrd import decode_jbrd

        return _reconstruct_from_jbrd(decode_jbrd(blob), stream,
                                      exif=exif, xmp=xmp)
    if blob[:1] == b"\x02":  # legacy round-1 VarDCT transcode layout
        from ..io.brotli import brotli_decompress

        return _reconstruct_from_vardct(brotli_decompress(blob[1:]), stream)
    if blob[:1] == b"\x01":  # Brotli-packed metadata
        from ..io.brotli import brotli_decompress

        blob = brotli_decompress(blob[1:])
    jd = _meta_from_blob(blob)
    r = BitReader(stream)
    dc_img = ModularImage(1, 1, 16, 0)
    dc_img.channel = [Channel(c.width_in_blocks, c.height_in_blocks)
                      for c in jd.components]
    modular_decode(r, dc_img)
    for i, c in enumerate(jd.components):
        hb, wb = c.height_in_blocks, c.width_in_blocks
        c.coeffs = np.zeros((hb, wb, 64), dtype=np.int16)
        c.coeffs[:, :, 0] = dc_img.channel[i].data
    _decode_jpeg_ac(r, jd)
    return write_jpeg(jd)


# ------------------------------------------------- VarDCT-frame transcode
# (ComputeJPEGTranscodingData analog: JPEG DCT coefficients become a real
# chroma-subsampled YCbCr VarDCT frame with RAW quant tables; the jbrd
# box carries the Brotli-packed non-coefficient bytes.)

_JPEG_TO_JXL_CHANNEL = {0: 1, 1: 0, 2: 2}  # Y, Cb, Cr -> (X, Y, B) slots


def _subsampling_mode(jd: JPEGData):
    """-> channel_mode list or None if the sampling doesn't map."""
    if len(jd.components) == 1:
        return [0, 1, 0], (1, 1)  # coded as 420 with zero chroma
    if len(jd.components) != 3:
        return None
    y, cb, cr = jd.components
    if (cb.h_samp, cb.v_samp) != (1, 1) or (cr.h_samp, cr.v_samp) != (1, 1):
        return None
    samp = (y.h_samp, y.v_samp)
    modes = {(1, 1): [0, 0, 0], (2, 2): [0, 1, 0], (2, 1): [0, 2, 0],
             (1, 2): [0, 3, 0]}
    if samp not in modes:
        return None
    return modes[samp], samp


def recompress_jpeg_vardct(data: bytes) -> bytes:
    """Recompress a JPEG into a REAL VarDCT YCbCr frame (444/420/422/440)
    plus a jbrd metadata box; reconstruct_jpeg rebuilds it bit-exactly."""
    from ..api.codestream import CodecMetadata, write_codestream_header
    from ..io.frame_header import (
        CT_YCBCR,
        ENC_VARDCT,
        FLAG_SKIP_ADAPTIVE_DC_SMOOTHING,
        FT_REGULAR,
        FrameHeader,
    )
    from ..io.brotli import brotli_compress
    from ..io.headers import SizeHeader
    from ..vardct.subsampled import (
        _shifts,
        channel_block_grid,
        encode_vardct_subsampled,
    )
    from .data import ZIGZAG

    jd = parse_jpeg(data)
    mapped = _subsampling_mode(jd)
    if mapped is None:
        return recompress_jpeg(data)  # exotic sampling: legacy token model
    mode, _samp = mapped
    meta = CodecMetadata()
    meta.size = SizeHeader().set(jd.width, jd.height)
    meta.m.all_default = False
    meta.m.xyb_encoded = False
    writer = BitWriter()
    write_codestream_header(writer, meta)
    fh = FrameHeader(meta)
    fh.all_default = False
    fh.frame_type = FT_REGULAR
    fh.encoding = ENC_VARDCT
    fh.color_transform = CT_YCBCR
    fh.chroma_subsampling.channel_mode = mode
    fh.flags = FLAG_SKIP_ADAPTIVE_DC_SMOOTHING
    fh.loop_filter.all_default = False
    fh.loop_filter.gab = False
    fh.loop_filter.epf_iters = 0
    fd = fh.frame_dimensions()
    hs, vs = _shifts(fh)
    grids = channel_block_grid(fd, hs, vs)

    # per-jxl-channel JPEG quant tables (natural order), zeros -> 1
    qtabs = np.ones((3, 8, 8), dtype=np.int32)
    for ji, comp in enumerate(jd.components):
        jc = _JPEG_TO_JXL_CHANNEL[ji]
        qz = np.asarray(jd.quant[comp.quant_idx], dtype=np.int32)
        nat = np.zeros(64, dtype=np.int32)
        nat[ZIGZAG] = qz
        # RAW tables live in the transposed VarDCT coefficient layout
        qtabs[jc] = nat.reshape(8, 8).T
    den = 1.0 / (8.0 * 255.0)  # JPEG->JXL DCT basis scale (F/8) / 255

    def matrices_setup(state):
        state.matrices.set_custom(0, ("raw", den, qtabs))
        state.matrices.set_custom_dc(
            [qtabs[c, 0, 0] / (8.0 * 255.0) for c in range(3)])
        state.quantizer.global_scale = 1 << 16  # inv_global_scale == 1
        state.quantizer.quant_dc = 1
        state.quantizer._recompute()

    qblocks = [dict() for _ in range(3)]
    dc = [np.zeros(g, dtype=np.float64) for g in grids]
    # f16-rounded DC factors (what the decoder reconstructs)
    fac = [float(np.float16(qtabs[c, 0, 0] / (8.0 * 255.0) * 128.0)) / 128.0
           for c in range(3)]
    for ji, comp in enumerate(jd.components):
        jc = _JPEG_TO_JXL_CHANNEL[ji]
        hb, wb = comp.coeffs.shape[:2]
        nat = np.zeros((hb, wb, 64), dtype=np.int64)
        nat[:, :, ZIGZAG] = comp.coeffs
        # VarDCT stores 8x8 coefficients transposed vs JPEG's natural
        # layout (ComputeJPEGTranscodingData transposes likewise)
        nat = nat.reshape(hb, wb, 8, 8).swapaxes(-2, -1).reshape(hb, wb, 64)
        for sby in range(min(hb, grids[jc][0])):
            for sbx in range(min(wb, grids[jc][1])):
                blk = nat[sby, sbx].copy()
                dc[jc][sby, sbx] = blk[0] * fac[jc]
                blk[0] = 0
                qblocks[jc][(sby, sbx)] = blk
    # fill grid blocks absent from the JPEG (padding) with zeros
    for c in range(3):
        for sby in range(grids[c][0]):
            for sbx in range(grids[c][1]):
                qblocks[c].setdefault((sby, sbx),
                                      np.zeros(64, dtype=np.int64))
    encode_vardct_subsampled(writer, None, fh,
                             precomputed={"qblocks": qblocks, "dc": dc},
                             matrices_setup=matrices_setup)
    # reference-format reconstruction data (jpeg/enc_jpeg_data.cc:314) —
    # the resulting container round-trips through libjxl's djxl too
    from .jbrd import jbrd_from_jpeg, encode_jbrd
    jb = jbrd_from_jpeg(data, jd)
    out = [CONTAINER_HEADER]
    out.append(make_box(b"jbrd", encode_jbrd(jb)))
    out.append(make_box(b"jxlc", writer.get_bytes()))
    return b"".join(out)


def _plane_block(plane, sby: int, sbx: int):
    """The 64 coefficients of block (sby, sbx) of a dense plane
    (vardct/subsampled.dense_planes), None outside it."""
    if (sby + 1) * 8 > plane.shape[0] or (sbx + 1) * 8 > plane.shape[1]:
        return None
    return plane[sby * 8:sby * 8 + 8, sbx * 8:sbx * 8 + 8].reshape(-1)


def _capture_vardct_state(stream: bytes):
    """Decode a transcoded VarDCT stream up to (but not through) the
    restoration pipeline and return (state, frame_header)."""
    from ..api.codestream import parse_codestream_header
    from ..io.frame_header import FrameHeader
    from ..vardct.frame import decode_vardct_frame

    r = BitReader(stream)
    meta = parse_codestream_header(r)
    fh = FrameHeader(meta)
    fh.read(r)
    captured = {}

    def capture(state):
        captured["state"] = state
        state.restoration_done = True

    decode_vardct_frame(r, fh, render_fn=capture)
    return captured["state"], fh


def _reconstruct_from_jbrd(jb, stream: bytes, exif: bytes = None,
                           xmp: bytes = None) -> bytes:
    """Rebuild the original JPEG from a reference-format jbrd payload plus
    the coefficients of the transcoded VarDCT frame (decode_to_jpeg.h:35 /
    dec_frame.cc:432-473 analog)."""
    from ..vardct.subsampled import _shifts, dense_planes
    from .jbrd import APP_UNKNOWN, fill_app_segments, jpeg_from_jbrd
    from .data import ZIGZAG

    st, fh = _capture_vardct_state(stream)
    if any(t != APP_UNKNOWN for t in jb.app_marker_type):
        ce = fh.nonserialized_metadata.m.color_encoding
        icc = ce.icc if getattr(ce, "want_icc", False) else None
        fill_app_segments(jb, icc=icc, exif=exif, xmp=xmp)
    fd = st.fd
    width = fh.nonserialized_metadata.size.xsize()
    height = fh.nonserialized_metadata.size.ysize()
    hs, vs = _shifts(fh)
    njpeg = len(jb.component_ids)
    if njpeg not in (1, 3):
        raise JXLError("unsupported JPEG component count")
    # jbrd quant values from the signaled RAW dequant table
    # (dec_frame.cc:458-462: values are the transposed stored table)
    den = 1.0 / (8.0 * 255.0)
    qt_set = set()
    for ji in range(njpeg):
        jc = _JPEG_TO_JXL_CHANNEL[ji] if njpeg == 3 else 1
        qpos = jb.comp_quant_idx[ji]
        qt_set.add(qpos)
        tab = np.round(st.matrices.dequant_matrix(0, jc) / den)
        nat = tab.T.astype(np.int64)  # stored layout -> natural raster
        jb.quant[qpos].values = [int(v) for v in nat.reshape(-1)]
    for i, q in enumerate(jb.quant):
        if i not in qt_set and i > 0 and q.values == [0] * 64:
            q.values = list(jb.quant[i - 1].values)
    fac = [st.quantizer.mul_dc(c) for c in range(3)]
    hsm, vsm = max(hs), max(vs)
    subsampled = hasattr(st, "qblocks_sub")
    planes = dense_planes(st) if subsampled else None
    mcux = -(-width // (8 << hsm))
    mcuy = -(-height // (8 << vsm))
    components = []
    for ji in range(njpeg):
        jc = _JPEG_TO_JXL_CHANNEL[ji] if njpeg == 3 else 1
        h_samp = 1 << (hsm - hs[jc])
        v_samp = 1 << (vsm - vs[jc])
        wb, hb = mcux * h_samp, mcuy * v_samp
        coeffs = np.zeros((hb, wb, 64), dtype=np.int32)
        for sby in range(hb):
            for sbx in range(wb):
                if subsampled:
                    blk = _plane_block(planes[jc], sby, sbx)
                    dcv = st.dc_sub[jc][sby, sbx] \
                        if sby < st.dc_sub[jc].shape[0] \
                        and sbx < st.dc_sub[jc].shape[1] else 0.0
                else:
                    joint = st.qblocks.get((sby, sbx))
                    blk = joint[jc] if joint is not None else None
                    dcv = st.dc[jc, sby, sbx] \
                        if sby < st.dc.shape[1] and sbx < st.dc.shape[2] \
                        else 0.0
                nat = np.zeros(64, dtype=np.int64)
                if blk is not None:
                    # stored transposed layout -> natural raster
                    nat[:] = np.asarray(blk).reshape(8, 8).T.reshape(-1)
                nat[0] = int(round(dcv / fac[jc]))
                coeffs[sby, sbx] = nat[ZIGZAG]
        components.append(dict(h_samp=h_samp, v_samp=v_samp, coeffs=coeffs))
    return jpeg_from_jbrd(jb, width, height, components)


def _reconstruct_from_vardct(blob: bytes, stream: bytes) -> bytes:
    from ..api.codestream import parse_codestream_header
    from ..io.frame_header import FrameHeader
    from ..vardct.frame import decode_vardct_frame
    from ..vardct.subsampled import _shifts, dense_planes
    from .data import ZIGZAG

    jd = _meta_from_blob(blob)
    r = BitReader(stream)
    meta = parse_codestream_header(r)
    fh = FrameHeader(meta)
    fh.read(r)
    captured = {}

    def capture(state):
        captured["state"] = state
        state.restoration_done = True

    decode_vardct_frame(r, fh, render_fn=capture)
    st = captured["state"]
    hs, vs = _shifts(fh)
    fac = [st.quantizer.mul_dc(c) for c in range(3)]
    subsampled = hasattr(st, "qblocks_sub")
    planes = dense_planes(st) if subsampled else None
    for ji, comp in enumerate(jd.components):
        jc = _JPEG_TO_JXL_CHANNEL[ji]
        hb, wb = comp.height_in_blocks, comp.width_in_blocks
        coeffs = np.zeros((hb, wb, 64), dtype=np.int32)
        for sby in range(hb):
            for sbx in range(wb):
                if subsampled:
                    blk = _plane_block(planes[jc], sby, sbx)
                    dcv = st.dc_sub[jc][sby, sbx]
                else:
                    joint = st.qblocks.get((sby, sbx))
                    blk = joint[jc] if joint is not None else None
                    dcv = st.dc[jc, sby, sbx]
                nat = np.zeros(64, dtype=np.int64)
                if blk is not None:
                    # undo the VarDCT transposed layout (see encode side)
                    nat[:] = np.asarray(blk).reshape(8, 8).T.reshape(-1)
                nat[0] = int(round(dcv / fac[jc]))
                coeffs[sby, sbx] = nat[ZIGZAG]
        comp.coeffs = coeffs.astype(np.int16)
    return write_jpeg(jd)
