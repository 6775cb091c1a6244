"""A baseline JPEG's coefficients and their lossless JPEG XL recompression,
frozen for the benchmark's JPEG transcode configuration; also the
coefficients read back from such a stream (the control's input).

- jpeg_components(rgb, quality): the quantized coefficients a baseline
  4:2:0 JPEG of `rgb` holds, as libjxl_tpu_torch's jpegli writes it with
  libjpeg's standard tables at `quality` (jpegli/encode.encode_jpegli with
  subsampling="420", std_tables=True, adaptive=False): BT.601 YCbCr, edge
  padding to whole MCUs, 2x2 chroma averages, the float DCT, quantization
  with jpegli's zero-bias dead zone. The JPEG's Huffman-coded bytes are not
  made: the recompression reads only the coefficients, tables and
  sampling.
- transcode(components, width, height): the JPEG XL container that
  libjxl_tpu_torch's jpeg/recompress.recompress_jpeg_vardct writes for
  them, the jxlc box alone (its jbrd box, which rebuilds the JPEG's bytes,
  is left out: a decode to pixels never reads it), but with libjxl's
  block context map for JPEG input (block_ctx_map): the port's writes the
  default map. The codestream is a VarDCT frame in YCbCr with the JPEG's
  sampling, its tables as a raw dequantization table, its DC steps as
  float16, all 8x8 DCT, no Gaborish, no EPF, one pass (vardct/subsampled.
  encode_vardct_subsampled with precomputed coefficients); the AC tokens
  are made array-wise, in the order of its per-block loop.
- block_ctx_map(dc): the block contexts libjxl's encoder gives a JPEG's
  coefficients (lib/jxl/enc_frame.cc, ComputeJPEGTranscodingData), up to
  two DC thresholds a channel from about 1024x768 up, as libjxl 0.7's
  transcodes signal them.
- read_coefficients(stream): transcode's inverse, (components, width,
  height), the AC read symbol by symbol (vardct/subsampled.
  decode_ac_group_sub).

Built from the frozen modules beside it (entropy, modular, io, vardct);
nothing here imports the port, JAX or the JAX package.
"""

from __future__ import annotations

import struct

import numpy as np

from .api.codestream import parse_codestream_header, write_codestream_header
from .base.status import JXLError
from .entropy.decode import ANSSymbolReader, decode_histograms
from .entropy.encode import TokenArray, build_and_encode_histograms, \
    write_tokens
from .io.bits import BitReader, BitWriter
from .entropy.decode import decode_context_map
from .entropy.encode import encode_context_map
from .io.fields import Bits, BitsOffset, U32Enc, f16_read, f16_write, \
    pack_signed, u32_read, u32_write, unpack_signed
from .io.frame_header import (CT_YCBCR, ENC_VARDCT,
                              FLAG_SKIP_ADAPTIVE_DC_SMOOTHING, FT_REGULAR,
                              FrameHeader)
from .io.headers import CodecMetadata, SizeHeader
from .io.toc import read_group_offsets, write_group_offsets
from .modular.codec import GroupHeader, ModularOptions, _tokenize_channel, \
    modular_decode
from .modular.image import Channel, ModularImage
from .modular.predict import P_GRADIENT
from .modular.tree import decode_tree, encode_tree, make_fixed_tree, \
    num_tree_contexts
from .ops.dct import fwd_matrix
from .vardct import ac_strategy as acs
from .vardct.coeff_order import compute_coeff_orders, decode_coeff_orders, \
    encode_coeff_orders
from .vardct.ctx import COEFF_FREQ_CONTEXT, COEFF_NUM_NONZERO_CONTEXT, \
    NONZERO_BUCKETS, ZERO_DENSITY_CONTEXT_COUNT, BlockCtxMap
from .vardct.frame import ORDER_ENC, QuantizerParams

# T.81 Figure A.6: the natural (row-major) index of each zigzag position
ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
                   21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
                   30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
                   61, 54, 47, 55, 62, 63])
# ITU-T T.81 Annex K tables K.1 (luminance) and K.2 (chrominance),
# natural order (jpegli/tables.BASE_QUANT_STD)
STD_TABLES = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
     99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99]],
    dtype=np.float64)
# jpegli's AC dead zone per component without adaptive quantization
# (jpegli/tables.ZERO_BIAS_OFFSET_AC, quant.cc:518); the DC's is 0
ZERO_BIAS_OFFSET_AC = (0.59082, 0.58146, 0.57988)
# JPEG component (Y, Cb, Cr) -> JPEG XL channel
JXL_CHANNEL = (1, 0, 2)
# a JPEG's luma sampling -> the JPEG XL frame's chroma channel mode
CHANNEL_MODE = {(1, 1): [0, 0, 0], (2, 2): [0, 1, 0], (2, 1): [0, 2, 0],
                (1, 2): [0, 3, 0]}
CONTAINER_HEADER = bytes([
    0, 0, 0, 0xC, 0x4A, 0x58, 0x4C, 0x20, 0xD, 0xA, 0x87, 0xA,
    0, 0, 0, 0x14, 0x66, 0x74, 0x79, 0x70, 0x6A, 0x78, 0x6C, 0x20,
    0, 0, 0, 0, 0x6A, 0x78, 0x6C, 0x20])
NUM_QUANT_TABLES = 17
MODE_LIBRARY, MODE_RAW = 0, 7
DC_DEN = 8.0 * 255.0  # a JPEG DCT step in JPEG XL's pixel / 255 units


# ------------------------------------------------------------------ JPEG
def quant_tables(quality: int) -> np.ndarray:
    """(2, 64) natural-order tables: libjpeg's scaling of the Annex K
    tables as jpegli computes it (quality_to_distance,
    distance_to_linear_quality, make_quant_tables with std_tables)."""
    q = int(quality)
    if not 50 <= q <= 100:
        raise ValueError("quality outside 50..100")
    distance = 0.01 if q == 100 else 0.1 + (100 - q) * 0.09
    linear = 1.0 if distance <= 0.1 else (200.0 / 9.0) * (distance - 0.1)
    return np.clip(np.round(0.01 * linear * STD_TABLES), 1, 255)


def jpeg_components(rgb: np.ndarray, quality: int) -> list:
    """The three components of a baseline 4:2:0 JPEG of u8 rgb (H, W, 3):
    [(coefficients int32 (rows of blocks, blocks a row, 64) in zigzag
    order, table (64,) in zigzag order, h_samp, v_samp)], Y first."""
    r, g, b = (rgb[..., k].astype(np.float32) for k in range(3))
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0,
              0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0]
    tables = quant_tables(quality)
    h, w = rgb.shape[:2]
    out = []
    for ci, plane in enumerate(planes):
        p = np.pad(np.asarray(plane, np.float32),
                   ((0, (-h) % 16), (0, (-w) % 16)), mode="edge")
        if ci:
            p = p.reshape(p.shape[0] // 2, 2, p.shape[1] // 2, 2).mean(
                axis=(1, 3))
        table = tables[min(ci, 1)]
        nby, nbx = p.shape[0] // 8, p.shape[1] // 8
        blocks = p.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3).reshape(
            -1, 8, 8).astype(np.float64)
        f8 = fwd_matrix(8)
        dct = (f8 @ blocks @ f8.T).reshape(-1, 64)
        qmc = 8.0 / table
        qval = dct * qmc
        nat = np.where(np.abs(qval) >= np.float32(ZERO_BIAS_OFFSET_AC[ci]),
                       np.round(qval), 0.0)
        # the DC's dead zone is 0: its hysteresis never holds a value
        nat[:, 0] = np.round((dct[:, 0] - 128.0) * qmc[0])
        zz = nat.astype(np.int32)[:, ZIGZAG].reshape(nby, nbx, 64)
        samp = (2, 2) if ci == 0 else (1, 1)
        out.append((zz, table[ZIGZAG].astype(np.int32), *samp))
    return out


# ----------------------------------------------------- block contexts
# entropy_coder.cc DecodeBlockCtxMap: a DC threshold's U32 distribution
DC_THRESHOLD_ENC = U32Enc(Bits(4), BitsOffset(8, 16), BitsOffset(16, 272),
                          BitsOffset(32, 65808))


def block_ctx_map(dc) -> BlockCtxMap:
    """libjxl's block contexts for a JPEG's quantized DC, dc[c] per JPEG
    XL channel (enc_frame.cc, ComputeJPEGTranscodingData): channel c gets
    (CeilLog2(its blocks) - 12) // 2 thresholds, at most 2, at the
    quantiles of its DC values (dark/medium/bright luma, yellow/unsat/
    blue and green/unsat/red chroma); a luma block takes a context for
    each pair of chroma buckets, a chroma block one for each luma bucket;
    no quant-field thresholds."""
    b = BlockCtxMap()
    for c in range(3):
        values = np.asarray(dc[c]).reshape(-1)
        total = values.size
        n = min(max(((total - 1).bit_length() - 12) // 2, 0), 2)
        cumsum = np.cumsum(np.bincount(np.clip(values + 1024, 0, 2047),
                                       minlength=2048))
        thresholds, cut = [], total // (n + 1)
        for j in range(2048):
            if cumsum[j] > cut:
                thresholds.append(j - 1025)
                cut = total * (len(thresholds) + 1) // (n + 1)
        b.dc_thresholds[c] = thresholds
    ndc = int(np.prod([len(t) + 1 for t in b.dc_thresholds]))
    luma = len(b.dc_thresholds[1]) + 1
    ctx_map = [0] * (3 * acs.NUM_ORDERS * ndc)
    for i in range(ndc):
        ctx_map[i] = i // luma
        ctx_map[acs.NUM_ORDERS * ndc + i] = \
            ctx_map[2 * acs.NUM_ORDERS * ndc + i] = ndc // luma + i % luma
    b.ctx_map, b.num_ctxs, b.num_dc_ctxs = ctx_map, max(ctx_map) + 1, ndc
    return b


def dc_contexts(bcm: BlockCtxMap, dc, hs, vs, shape) -> np.ndarray:
    """Each luma block's DC context (compressed_dc.cc DequantDC): channel
    c's bucket is the count of its thresholds below its DC at the block,
    the buckets combined as (b0 * (n2 + 1) + b2) * (n1 + 1) + b1."""
    ys, xs = np.arange(shape[0]), np.arange(shape[1])
    b = [np.zeros(shape, np.int64) for _ in range(3)]
    for c in range(3):
        at = dc[c][(ys >> vs[c])[:, None], (xs >> hs[c])[None, :]]
        for t in bcm.dc_thresholds[c]:
            b[c] += at > t
    n = [len(t) + 1 for t in bcm.dc_thresholds]
    return (b[0] * n[2] + b[2]) * n[1] + b[1]


def _write_block_ctx_map(bcm: BlockCtxMap, w) -> None:
    w.write(1, 0)  # not the default map
    for c in range(3):
        w.write(4, len(bcm.dc_thresholds[c]))
        for t in bcm.dc_thresholds[c]:
            u32_write(DC_THRESHOLD_ENC, pack_signed(t), w)
    w.write(4, 0)  # no quant-field thresholds
    encode_context_map(bcm.ctx_map, bcm.num_ctxs, w)


def _read_block_ctx_map(r) -> BlockCtxMap:
    b = BlockCtxMap()
    if r.read_bits(1):
        return b
    for c in range(3):
        b.dc_thresholds[c] = [unpack_signed(u32_read(DC_THRESHOLD_ENC, r))
                              for _ in range(r.read_bits(4))]
    if r.read_bits(4):
        raise JXLError("quant-field thresholds: not this writer's map")
    b.num_dc_ctxs = int(np.prod([len(t) + 1 for t in b.dc_thresholds]))
    if b.num_dc_ctxs > 64:
        raise JXLError("invalid block context map: too big")
    b.ctx_map, b.num_ctxs = decode_context_map(
        3 * acs.NUM_ORDERS * b.num_dc_ctxs, r)
    return b


def _block_contexts(bcm: BlockCtxMap, dc_idx, c: int) -> np.ndarray:
    """Channel c's DCT8 block context at each luma block's DC context."""
    base = ((c ^ 1) if c < 2 else 2) * acs.NUM_ORDERS * bcm.num_dc_ctxs
    return np.asarray(bcm.ctx_map, np.int64)[base + dc_idx]


# ------------------------------------------------------------ transcode
def _frame_header(meta, mode) -> FrameHeader:
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
    return fh


def _shifts(fh):
    cs = fh.chroma_subsampling
    return ([cs.hshift(c) for c in range(3)],
            [cs.vshift(c) for c in range(3)])


def _grids(fd, hs, vs):
    return [((fd.ysize_blocks + (1 << vs[c]) - 1) >> vs[c],
             (fd.xsize_blocks + (1 << hs[c]) - 1) >> hs[c])
            for c in range(3)]


def _f16(v: float) -> float:
    return float(np.float16(v))


def _modular_tokens(planes, size, stream_id, tree, shifts=None) -> list:
    """The tokens of int32 planes as one modular image of size (w, h)
    under `tree`."""
    img = ModularImage(*size, 8, 0)
    for i, p in enumerate(planes):
        s = shifts[i] if shifts else (0, 0)
        img.channel.append(Channel(p.shape[1], p.shape[0], s[0], s[1],
                                   np.ascontiguousarray(p, np.int32)))
    tokens = []
    wp = GroupHeader().wp_header
    for i in range(len(planes)):
        _tokenize_channel(img, i, stream_id, tree, wp, tokens)
    return tokens


def _ac_group_tokens(blocks, orders, fd, hs, vs, g, bcm, dc_idx) -> list:
    """One AC group's tokens (vardct/subsampled.tokenize_ac_group_sub),
    array-wise: per block in luma raster order, channels 1, 0, 2 where a
    channel's block starts, its nonzero count in a context predicted from
    the block above and to the left in the group, then its coefficients
    in scan order up to the last nonzero in zero-density contexts; the
    block context from bcm at the luma block's DC context dc_idx."""
    gdim = fd.group_dim // 8
    gx, gy = g % fd.xsize_groups, g // fd.xsize_groups
    bx0, by0 = gx * gdim, gy * gdim
    bw = min(gdim, fd.xsize_blocks - bx0)
    bh = min(gdim, fd.ysize_blocks - by0)
    rank = {1: 0, 0: 1, 2: 2}
    keys, rows_ctx, rows_val, lasts = [], [], [], []
    for c in range(3):
        ch = (bh + (1 << vs[c]) - 1) >> vs[c]
        cw = (bw + (1 << hs[c]) - 1) >> hs[c]
        sy0, sx0 = by0 >> vs[c], bx0 >> hs[c]
        scan = blocks[c][sy0:sy0 + ch, sx0:sx0 + cw][..., orders[c]]
        nz = np.count_nonzero(scan[..., 1:], axis=-1)
        top = np.vstack([np.zeros((1, cw), np.int64), nz[:-1]])
        left = np.hstack([np.zeros((ch, 1), np.int64), nz[:, :-1]])
        pred = (top + left + 1) // 2
        pred[0, :] = left[0, :]
        pred[:, 0] = top[:, 0]
        pred[0, 0] = 32
        pred = np.minimum(pred, 64)
        # the block context of the DCT8 order class at the block's DC
        # context (no quant-field thresholds)
        bctx = _block_contexts(bcm, dc_idx[by0:by0 + bh:1 << vs[c],
                                           bx0:bx0 + bw:1 << hs[c]], c)
        nz_ctx = np.where(pred < 8, pred, 4 + pred // 2) * bcm.num_ctxs \
            + bctx
        histo = (bcm.num_ctxs * NONZERO_BUCKETS
                 + ZERO_DENSITY_CONTEXT_COUNT * bctx).reshape(-1, 1)
        flat = scan.reshape(-1, 64).astype(np.int64)
        nzf = nz.reshape(-1)
        k = np.arange(64)
        nonzero = flat != 0
        nonzero[:, 0] = False
        # nonzeros before position k, and whether position k - 1 was one
        before = np.cumsum(nonzero, axis=1) - nonzero
        remaining = np.clip(nzf[:, None] - before, 0, 63)
        prev = np.zeros_like(flat)
        prev[:, 2:] = nonzero[:, 1:-1]
        prev[:, 1] = nzf <= 4
        zctx = histo + (COEFF_NUM_NONZERO_CONTEXT[remaining]
                        + COEFF_FREQ_CONTEXT[k]) * 2 + prev
        u = np.where(flat >= 0, flat * 2, -flat * 2 - 1)
        ctx = zctx.astype(np.int32)
        ctx[:, 0] = nz_ctx.reshape(-1)
        u[:, 0] = nzf
        last = np.where(nonzero, k, 0).max(axis=1)
        sy, sx = np.mgrid[0:ch, 0:cw]
        keys.append((((sy << vs[c]) * bw + (sx << hs[c])) * 3
                     + rank[c]).reshape(-1))
        rows_ctx.append(ctx)
        rows_val.append(u)
        lasts.append(last)
    order = np.argsort(np.concatenate(keys), kind="stable")
    ctx = np.concatenate(rows_ctx)[order]
    val = np.concatenate(rows_val)[order]
    keep = np.arange(64)[None, :] <= np.concatenate(lasts)[order][:, None]
    return [TokenArray(ctx[keep], val[keep])]


def transcode(components, width: int, height: int) -> bytes:
    """The JPEG XL container of a JPEG's components (jpeg_components'
    form; sampling 4:4:4, 4:2:0, 4:2:2 or 4:4:0)."""
    y = components[0]
    mode = CHANNEL_MODE[(y[2], y[3])]
    meta = CodecMetadata()
    meta.size = SizeHeader().set(width, height)
    meta.m.all_default = False
    meta.m.xyb_encoded = False
    writer = BitWriter()
    write_codestream_header(writer, meta)
    fh = _frame_header(meta, mode)
    fd = fh.frame_dimensions()
    hs, vs = _shifts(fh)
    grids = _grids(fd, hs, vs)

    # per-channel tables, natural order transposed (the VarDCT layout),
    # each channel's AC blocks, transposed likewise, and its DC; padding
    # blocks 0
    qtabs = np.ones((3, 8, 8), dtype=np.int32)
    blocks = [np.zeros((*grids[c], 64), dtype=np.int64) for c in range(3)]
    dc = [np.zeros(grids[c], dtype=np.int64) for c in range(3)]
    for ji, (zz, qz, _, _) in enumerate(components):
        jc = JXL_CHANNEL[ji]
        nat = np.zeros(64, dtype=np.int32)
        nat[ZIGZAG] = qz
        qtabs[jc] = nat.reshape(8, 8).T
        hb, wb = min(zz.shape[0], grids[jc][0]), min(zz.shape[1],
                                                     grids[jc][1])
        co = np.zeros((hb, wb, 64), dtype=np.int64)
        co[..., ZIGZAG] = zz[:hb, :wb]
        blocks[jc][:hb, :wb] = co.reshape(hb, wb, 8, 8).swapaxes(
            -2, -1).reshape(hb, wb, 64)
        dc[jc][:hb, :wb] = co[..., 0]
        blocks[jc][..., 0] = 0
    dc_quant = [_f16(qtabs[c, 0, 0] / DC_DEN * 128.0) / 128.0
                for c in range(3)]

    tree = make_fixed_tree(P_GRADIENT)
    tree_writer = BitWriter()
    dec_tree = encode_tree(tree, tree_writer)
    dc_streams = []
    for g in range(fd.num_dc_groups):
        x0, y0, rw, rh = fd.dc_group_rect(g)
        planes, shifts = [], []
        for c in (1, 0, 2):
            cw = (rw + (1 << hs[c]) - 1) >> hs[c]
            ch = (rh + (1 << vs[c]) - 1) >> vs[c]
            sy0, sx0 = y0 >> vs[c], x0 >> hs[c]
            planes.append(dc[c][sy0:sy0 + ch, sx0:sx0 + cw])
            shifts.append((hs[c], vs[c]))
        dc_tokens = _modular_tokens(planes, (rw, rh), 1 + g, dec_tree,
                                    shifts)
        # AC metadata: no CfL, every block a DCT8 of quant 1, sharpness 0
        count = rw * rh
        cr = (-(-rh // 8), -(-rw // 8))
        meta_tokens = _modular_tokens(
            [np.zeros(cr, np.int32), np.zeros(cr, np.int32),
             np.zeros((2, count), np.int32), np.zeros((rh, rw), np.int32)],
            (rw, rh), 1 + 2 * fd.num_dc_groups + g, dec_tree,
            [(3, 3), (3, 3), (0, 0), (0, 0)])
        dc_streams.append((dc_tokens, meta_tokens, count))
    histo_writer = BitWriter()
    codes, context_map = build_and_encode_histograms(
        [[]] + [t for d, m, _ in dc_streams for t in (d, m)],
        num_tree_contexts(dec_tree), histo_writer)

    # coefficient orders from the zero counts (compute_coeff_orders);
    # small grids keep the natural order
    ord0 = acs.STRATEGY_ORDER[acs.DCT]
    num_zeros = {(ord0, c): np.count_nonzero(
        blocks[c].reshape(-1, 64) == 0, axis=0).astype(np.int64)
        for c in range(3)}
    used_orders, orders = compute_coeff_orders(
        num_zeros, {acs.DCT},
        customize=fd.xsize_blocks >= 5 or fd.ysize_blocks >= 5)
    natural = acs.natural_coeff_order(acs.DCT)
    ch_orders = [np.asarray(orders.get((ord0, c), natural), np.int64)
                 for c in range(3)]
    bcm = block_ctx_map(dc)
    dc_idx = dc_contexts(bcm, dc, hs, vs,
                         (fd.ysize_blocks, fd.xsize_blocks))
    group_tokens = [_ac_group_tokens(blocks, ch_orders, fd, hs, vs, g, bcm,
                                     dc_idx)
                    for g in range(fd.num_groups)]
    ac_histo_writer = BitWriter()
    ac_codes, ac_cmap = build_and_encode_histograms(
        group_tokens, bcm.num_ac_contexts(), ac_histo_writer)

    def dc_global(w):
        w.write(1, 0)  # custom DC steps (DequantMatrices::EncodeDC)
        for c in range(3):
            f16_write(dc_quant[c] * 128.0, w)
        p = QuantizerParams()
        p.global_scale, p.quant_dc = 1 << 16, 1  # inv_global_scale 1
        p.write(w)
        _write_block_ctx_map(bcm, w)
        # a zero CfL (IsJPEGCompatible, chroma_from_luma.h:62-66)
        w.write(1, 0)
        w.write(2, 0)
        f16_write(0.0, w)
        f16_write(0.0, w)
        w.write(8, 128)
        w.write(8, 128)
        w.write(1, 1)  # a global tree
        w.append_bits_from(tree_writer)
        w.append_bits_from(histo_writer)

    def dc_group(w, g):
        dc_tokens, meta_tokens, count = dc_streams[g]
        w.write(2, 0)  # extra precision
        for tokens, n in ((dc_tokens, None), (meta_tokens, count)):
            if n is not None:
                x0, y0, rw, rh = fd.dc_group_rect(g)
                nbits = (rw * rh - 1).bit_length() if rw * rh > 1 else 0
                if nbits:
                    w.write(nbits, n - 1)
            gh = GroupHeader()
            gh.use_global_tree = True
            gh.write(w)
            write_tokens(tokens, codes, context_map, w)

    def ac_global(w):
        w.write(1, 0)  # not all library tables
        for kind in range(NUM_QUANT_TABLES):
            if kind:
                w.write(3, MODE_LIBRARY)
                continue
            w.write(3, MODE_RAW)
            f16_write(_f16(1.0 / DC_DEN), w)
            gh = GroupHeader()  # a local tree
            gh.write(w)
            qtree = encode_tree(make_fixed_tree(P_GRADIENT), w)
            tokens = _modular_tokens(list(qtabs), (8, 8),
                                     1 + 3 * fd.num_dc_groups + kind, qtree)
            qcodes, qcmap = build_and_encode_histograms(
                [tokens], num_tree_contexts(qtree), w)
            write_tokens(tokens, qcodes, qcmap, w)
        nbits = (fd.num_groups - 1).bit_length() if fd.num_groups > 1 else 0
        if nbits:
            w.write(nbits, 0)  # one histogram set
        u32_write(ORDER_ENC, used_orders, w)
        encode_coeff_orders(used_orders, orders, w)
        w.append_bits_from(ac_histo_writer)

    sections = []
    if fd.num_groups == 1:
        w = BitWriter()
        dc_global(w)
        dc_group(w, 0)
        ac_global(w)
        write_tokens(group_tokens[0], ac_codes, ac_cmap, w)
        sections.append(w.get_bytes())
    else:
        parts = [dc_global] + [lambda w, g=g: dc_group(w, g)
                               for g in range(fd.num_dc_groups)]
        parts += [ac_global] + [
            lambda w, g=g: write_tokens(group_tokens[g], ac_codes, ac_cmap,
                                        w) for g in range(fd.num_groups)]
        for part in parts:
            w = BitWriter()
            part(w)
            sections.append(w.get_bytes())
    fh.write(writer)
    write_group_offsets([len(s) for s in sections], None, writer)
    writer.zero_pad_to_byte()
    for s in sections:
        writer.append_bytes(s)
    code = writer.get_bytes()
    return CONTAINER_HEADER + struct.pack(">I", 8 + len(code)) + b"jxlc" \
        + code


# --------------------------------------------------------- read back
def _codestream(data: bytes) -> bytes:
    if data[:12] != CONTAINER_HEADER[:12]:
        return data
    pos = len(CONTAINER_HEADER)
    while pos + 8 <= len(data):
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"jxlc":
            return data[pos + 8:pos + size] if size else data[pos + 8:]
        pos += size
    raise JXLError("no jxlc box")


def read_coefficients(data: bytes):
    """The components, width and height of a stream transcode wrote:
    ([(coefficients int32 (rows, cols, 64) zigzag, table (64,) zigzag,
    h_samp, v_samp)], width, height), blocks at the JPEG XL channel's
    grid."""
    r = BitReader(_codestream(data))
    meta = parse_codestream_header(r)
    fh = FrameHeader(meta)
    fh.read(r)
    fd = fh.frame_dimensions()
    if fh.color_transform != CT_YCBCR or fh.passes.num_passes != 1:
        raise JXLError("not a JPEG transcode of this writer")
    hs, vs = _shifts(fh)
    grids = _grids(fd, hs, vs)
    n = 1 if fd.num_groups == 1 else 2 + fd.num_dc_groups + fd.num_groups
    offsets, sizes, _ = read_group_offsets(n, r)
    r.jump_to_byte_boundary()
    base = r.total_bits_consumed() // 8
    buf = r.data

    def section(i):
        return BitReader(buf[base + offsets[i]:base + offsets[i]
                             + sizes[i]])

    sr = section(0)
    if sr.read_bits(1):
        raise JXLError("library DC steps: not a JPEG transcode")
    dc_quant = [f16_read(sr) / 128.0 for _ in range(3)]
    QuantizerParams().read(sr)
    bcm = _read_block_ctx_map(sr)
    sr.read_bits(1 + 2)
    f16_read(sr)
    f16_read(sr)
    sr.read_bits(16)
    if not sr.read_bits(1):
        raise JXLError("no global tree")
    tree = decode_tree(sr, 1 << 20)
    code, cmap = decode_histograms(sr, num_tree_contexts(tree))
    dc = [np.zeros(g, dtype=np.int64) for g in grids]
    for g in range(fd.num_dc_groups):
        if fd.num_groups > 1:
            sr = section(1 + g)
        sr.read_bits(2)
        x0, y0, rw, rh = fd.dc_group_rect(g)
        img = ModularImage(rw, rh, 8, 0)
        dims = []
        for c in (1, 0, 2):
            cw = (rw + (1 << hs[c]) - 1) >> hs[c]
            ch = (rh + (1 << vs[c]) - 1) >> vs[c]
            dims.append((c, cw, ch))
            img.channel.append(Channel(cw, ch, hs[c], vs[c]))
        modular_decode(sr, img, 1 + g, ModularOptions(), global_tree=tree,
                       global_code=code, global_ctx_map=cmap)
        for i, (c, cw, ch) in enumerate(dims):
            sy0, sx0 = y0 >> vs[c], x0 >> hs[c]
            dc[c][sy0:sy0 + ch, sx0:sx0 + cw] = img.channel[i].data
        if fd.num_groups == 1:
            # the AC metadata: every block a DCT8 of quant 1
            count = rw * rh
            nbits = (count - 1).bit_length() if count > 1 else 0
            sr.read_bits(nbits)
            meta_img = ModularImage(rw, rh, 8, 0)
            meta_img.channel = [Channel(-(-rw // 8), -(-rh // 8), 3, 3),
                                Channel(-(-rw // 8), -(-rh // 8), 3, 3),
                                Channel(count, 2, 0, 0),
                                Channel(rw, rh, 0, 0)]
            modular_decode(sr, meta_img, 1 + 2 * fd.num_dc_groups + g,
                           ModularOptions(), global_tree=tree,
                           global_code=code, global_ctx_map=cmap)
    if fd.num_groups > 1:
        sr = section(1 + fd.num_dc_groups)
    if sr.read_bits(1):
        raise JXLError("library tables: not a JPEG transcode")
    qtabs = None
    for kind in range(NUM_QUANT_TABLES):
        mode = sr.read_bits(3)
        if kind == 0 and mode == MODE_RAW:
            f16_read(sr)
            img = ModularImage(8, 8, 8, 0)
            img.channel = [Channel(8, 8, 0, 0) for _ in range(3)]
            modular_decode(sr, img, 1 + 3 * fd.num_dc_groups)
            qtabs = np.stack([ch.data for ch in img.channel])
        elif mode != MODE_LIBRARY:
            raise JXLError("a quant table other than this writer's")
    if fd.num_groups > 1:
        nbits = (fd.num_groups - 1).bit_length()
        if sr.read_bits(nbits):
            raise JXLError("several histogram sets")
    orders = decode_coeff_orders(u32_read(ORDER_ENC, sr), sr)
    dc_idx = dc_contexts(bcm, dc, hs, vs, (fd.ysize_blocks, fd.xsize_blocks))
    ac_code, ac_cmap = decode_histograms(sr, bcm.num_ac_contexts())
    natural = acs.natural_coeff_order(acs.DCT)
    ord0 = acs.STRATEGY_ORDER[acs.DCT]
    ch_orders = [orders.get((ord0, c), natural) for c in range(3)]
    blocks = [np.zeros((*g, 64), dtype=np.int64) for g in grids]
    for g in range(fd.num_groups):
        if fd.num_groups > 1:
            sr = section(2 + fd.num_dc_groups + g)
        _read_ac_group(sr, ac_code, ac_cmap, bcm, dc_idx, blocks, ch_orders,
                       fd, hs, vs, g)
    comps = []
    for ji in range(3):
        jc = JXL_CHANNEL[ji]
        blk = blocks[jc].copy()
        blk[..., 0] = dc[jc]
        nat = blk.reshape(*blk.shape[:2], 8, 8).swapaxes(-2, -1).reshape(
            *blk.shape[:2], 64)
        table = qtabs[jc].T.reshape(64)
        samp = (1 << (max(hs) - hs[jc]), 1 << (max(vs) - vs[jc]))
        comps.append((nat[..., ZIGZAG].astype(np.int32),
                      table[ZIGZAG].astype(np.int32), *samp))
    if dc_quant != [_f16(qtabs[c, 0, 0] / DC_DEN * 128.0) / 128.0
                    for c in range(3)]:
        raise JXLError("DC steps other than the table's")
    return comps, fd.xsize, fd.ysize


def _read_ac_group(r, code, cmap, bcm, dc_idx, blocks, orders, fd, hs, vs,
                   g):
    """One AC group's coefficients, symbol by symbol (dec_group.cc
    LoadBlock with shifts)."""
    gdim = fd.group_dim // 8
    gx, gy = g % fd.xsize_groups, g // fd.xsize_groups
    bx0, by0 = gx * gdim, gy * gdim
    bw = min(gdim, fd.xsize_blocks - bx0)
    bh = min(gdim, fd.ysize_blocks - by0)
    reader = ANSSymbolReader(code, r)
    nzeros = [np.zeros(((bh + (1 << vs[c]) - 1) >> vs[c],
                        (bw + (1 << hs[c]) - 1) >> hs[c]), np.int64)
              for c in range(3)]
    bctx = [_block_contexts(bcm, dc_idx[by0:by0 + bh, bx0:bx0 + bw], c)
            .tolist() for c in range(3)]
    for by in range(bh):
        for bx in range(bw):
            for c in (1, 0, 2):
                sbx, sby = bx >> hs[c], by >> vs[c]
                if (sbx << hs[c]) != bx or (sby << vs[c]) != by:
                    continue
                nzm = nzeros[c]
                if sbx == 0:
                    pred = nzm[sby - 1, 0] if sby else 32
                elif sby == 0:
                    pred = nzm[0, sbx - 1]
                else:
                    pred = (nzm[sby - 1, sbx] + nzm[sby, sbx - 1] + 1) // 2
                pred = min(int(pred), 64)
                ctx = (pred if pred < 8 else 4 + pred // 2) * bcm.num_ctxs \
                    + bctx[c][by][bx]
                nz = reader.read_hybrid_uint(ctx, r, cmap)
                if nz > 63:
                    raise JXLError("invalid AC nzeros")
                nzm[sby, sbx] = nz
                histo = bcm.num_ctxs * NONZERO_BUCKETS \
                    + ZERO_DENSITY_CONTEXT_COUNT * bctx[c][by][bx]
                blk = blocks[c][(by0 >> vs[c]) + sby, (bx0 >> hs[c]) + sbx]
                prev = 0 if nz > 4 else 1
                k, left = 1, nz
                while k < 64 and left:
                    zctx = (int(COEFF_NUM_NONZERO_CONTEXT[left])
                            + int(COEFF_FREQ_CONTEXT[k])) * 2 + prev
                    u = reader.read_hybrid_uint(histo + zctx, r, cmap)
                    blk[orders[c][k]] = (u >> 1) if not u & 1 \
                        else -((u + 1) >> 1)
                    prev = 1 if u else 0
                    left -= prev
                    k += 1
                if left:
                    raise JXLError("invalid AC block")
    if not reader.check_final_state():
        raise JXLError("AC group ANS final state mismatch")
