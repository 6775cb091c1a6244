"""Chroma-subsampled (4:2:0 / 4:2:2) YCbCr VarDCT coding.

Mirrors dec_group.cc's shift-aware block loop (dec_group.cc:247-432,
530-600): iteration runs over the luma-resolution block grid in raster
order; a chroma block is (de)coded at the positions where the luma grid
aligns with its top-left ((sbx << hshift) == bx). DCT8 strategy only —
the shape used by JPEG-recompressed content; nzeros context maps live at
each channel's subsampled resolution while the quant field stays on the
luma grid (dec_group.cc:555-575).
"""

from __future__ import annotations

import numpy as np

from ..base.status import JXLError
from ..entropy.decode import ANSSymbolReader
from ..entropy.encode import Token
from ..io.bits import BitReader, BitWriter
from ..modular.codec import ModularOptions, _tokenize_channel, modular_decode
from ..modular.image import Channel, ModularImage
from . import ac_strategy as acs
from .ctx import (
    QUANT_MAX,
    ZERO_DENSITY_CONTEXT_COUNT,
    predict_nzeros,
    zero_density_context,
)
from .frame import (
    _modular_stream_ids,
    adjust_quant_bias,
    dc_context,
    store_dc_context,
)


def _shifts(fh):
    cs = fh.chroma_subsampling
    return ([cs.hshift(c) for c in range(3)],
            [cs.vshift(c) for c in range(3)])


def channel_block_grid(fd, hs, vs):
    """Per-channel (nby, nbx) block grids."""
    return [((fd.ysize_blocks + (1 << vs[c]) - 1) >> vs[c],
             (fd.xsize_blocks + (1 << hs[c]) - 1) >> hs[c])
            for c in range(3)]


def decode_dc_group_sub(r: BitReader, state, dc_group_id: int) -> None:
    """ProcessDCGroup with per-channel subsampled VarDCTDC dims."""
    fd = state.fd
    from ..io.frame_header import FLAG_USE_DC_FRAME as _F_DCF

    if state.fh.flags & _F_DCF:
        # the subsampled DC path reads its own VarDCTDC streams; wiring
        # a 1:8 DC frame into the per-channel dc_sub grids is not
        # implemented — fail loudly instead of desyncing the bitstream
        raise JXLError("kUseDcFrame with subsampled chroma unsupported")
    hs, vs = _shifts(state.fh)
    vardct_dc, _modular_dc, ac_metadata = _modular_stream_ids(fd)
    x0, y0, rw, rh = fd.dc_group_rect(dc_group_id)
    extra_precision = r.read_bits(2)
    mul = 1.0 / (1 << extra_precision)
    img = ModularImage(rw, rh, 8, 0)
    dims = []
    for c in (1, 0, 2):  # modular channel order is Y, X(Cb), B(Cr)
        cw = (rw + (1 << hs[c]) - 1) >> hs[c]
        ch = (rh + (1 << vs[c]) - 1) >> vs[c]
        dims.append((c, cw, ch))
        img.channel.append(Channel(cw, ch, hs[c], vs[c]))
    modular_decode(r, img, vardct_dc(dc_group_id), ModularOptions(),
                   global_tree=state.tree, global_code=state.code,
                   global_ctx_map=state.context_map, undo_transforms=True)
    for i, (c, cw, ch) in enumerate(dims):
        fac = state.quantizer.mul_dc(c) * mul
        sx0 = x0 >> hs[c]
        sy0 = y0 >> vs[c]
        state.dc_sub[c][sy0:sy0 + ch, sx0:sx0 + cw] = \
            img.channel[i].data.astype(np.float64) * fac
    store_dc_context(state, (x0, y0, rw, rh),
                     [img.channel[1].data, img.channel[0].data,
                      img.channel[2].data], hs, vs)
    # ACMetadata stream: identical layout to 444 (luma grid)
    _decode_ac_metadata(r, state, dc_group_id)


def _decode_ac_metadata(r: BitReader, state, dc_group_id: int) -> None:
    from .frame import COLOR_TILE_DIM_IN_BLOCKS

    fd = state.fd
    _vardct_dc, _modular_dc, ac_metadata = _modular_stream_ids(fd)
    x0, y0, rw, rh = fd.dc_group_rect(dc_group_id)
    upper_bound = rw * rh
    nbits = (upper_bound - 1).bit_length() if upper_bound > 1 else 0
    count = r.read_bits(nbits) + 1
    cr_w = -(-rw // 8)
    cr_h = -(-rh // 8)
    img = ModularImage(rw, rh, 8, 0)
    img.channel = [
        Channel(cr_w, cr_h, 3, 3),
        Channel(cr_w, cr_h, 3, 3),
        Channel(count, 2, 0, 0),
        Channel(rw, rh, 0, 0),
    ]
    modular_decode(r, img, ac_metadata(dc_group_id), ModularOptions(),
                   global_tree=state.tree, global_code=state.code,
                   global_ctx_map=state.context_map, undo_transforms=True)
    tx0 = x0 // COLOR_TILE_DIM_IN_BLOCKS
    ty0 = y0 // COLOR_TILE_DIM_IN_BLOCKS
    state.ytox_map[ty0:ty0 + cr_h, tx0:tx0 + cr_w] = img.channel[0].data
    state.ytob_map[ty0:ty0 + cr_h, tx0:tx0 + cr_w] = img.channel[1].data
    acs_row = np.asarray(img.channel[2].data[0], dtype=np.int64)
    qf_row = np.asarray(img.channel[2].data[1], dtype=np.int64)
    sharp = img.channel[3].data.reshape(-1)
    # the blocks in raster order: an unplaced block takes the next entry,
    # which must be a DCT8; the first fault a block-by-block walk meets
    # (sharpness, overflow, strategy) is the one raised
    rect = (slice(y0, y0 + rh), slice(x0, x0 + rw))
    unset = (state.strategy[rect] < 0).reshape(-1)
    before = np.cumsum(unset) - unset
    take = unset & (before < count)
    wrong = np.zeros_like(take)
    wrong[take] = acs_row[before[take]] != acs.DCT
    faults = [(int(np.argmax(m)), k, msg) for k, (m, msg) in enumerate((
        ((sharp < 0) | (sharp >= 8), "invalid EPF sharpness"),
        (unset & ~take, "AC metadata overflow"),
        (wrong, "subsampled frames support DCT8 only"))) if m.any()]
    if faults:
        raise JXLError(min(faults)[2])
    if int(unset.sum()) != count:
        raise JXLError("AC metadata count mismatch")
    state.epf_sharpness[rect] = sharp.reshape(rh, rw)
    placed = take.reshape(rh, rw)
    state.strategy[rect][placed] = acs.DCT
    state.is_origin[rect][placed] = True
    state.raw_quant_field[rect][placed] = \
        1 + np.clip(qf_row[before[take]], 0, QUANT_MAX - 1)


def decode_ac_group_sub(r: BitReader, state, group_idx: int,
                        pass_idx: int = 0) -> None:
    """Shift-aware AC token read (dec_group.cc LoadBlock)."""
    fd = state.fd
    hs, vs = _shifts(state.fh)
    gx = group_idx % fd.xsize_groups
    gy = group_idx // fd.xsize_groups
    bx0 = gx * (fd.group_dim // 8)
    by0 = gy * (fd.group_dim // 8)
    bw = min(fd.group_dim // 8, fd.xsize_blocks - bx0)
    bh = min(fd.group_dim // 8, fd.ysize_blocks - by0)
    code = state.ac_code[pass_idx]
    cmap = state.ac_context_map[pass_idx]
    reader = ANSSymbolReader(code, r)
    bcm = state.block_ctx_map
    pass_orders = state.orders[pass_idx] if pass_idx < len(state.orders) \
        else {}
    natural = acs.natural_coeff_order(acs.DCT)
    orders = [pass_orders.get((acs.STRATEGY_ORDER[acs.DCT], c), natural)
              for c in range(3)]
    # per-channel nzeros maps at subsampled in-group resolution
    nzeros = [np.zeros(((bh + (1 << vs[c]) - 1) >> vs[c],
                        (bw + (1 << hs[c]) - 1) >> hs[c]), dtype=np.int32)
              for c in range(3)]
    for by in range(bh):
        for bx in range(bw):
            aby, abx = by0 + by, bx0 + bx
            quant = int(state.raw_quant_field[aby, abx])
            dc_idx = dc_context(state, aby, abx)
            for c in (1, 0, 2):
                sbx = bx >> hs[c]
                sby = by >> vs[c]
                if (sbx << hs[c]) != bx or (sby << vs[c]) != by:
                    continue
                key = (aby >> vs[c], abx >> hs[c])
                if key not in state.qblocks_sub[c]:
                    state.qblocks_sub[c][key] = np.zeros(64, dtype=np.int64)
                qblock = state.qblocks_sub[c][key]
                pred = predict_nzeros(nzeros[c][None], 0, sby, sbx)
                block_ctx = bcm.context(dc_idx, quant,
                                        acs.STRATEGY_ORDER[0], c)
                nz_ctx = bcm.nonzero_context(pred, block_ctx)
                nzv = reader.read_hybrid_uint(nz_ctx, r, cmap)
                if nzv > 63:
                    raise JXLError("invalid AC nzeros")
                nzeros[c][sby, sbx] = nzv
                histo_offset = bcm.zero_density_contexts_offset(block_ctx)
                order = orders[c]
                prev = 0 if nzv > 4 else 1
                k = 1
                remaining = nzv
                while k < 64 and remaining != 0:
                    zctx = zero_density_context(remaining, k, 1, 0, prev)
                    if zctx >= ZERO_DENSITY_CONTEXT_COUNT:
                        raise JXLError("invalid AC zero-density context")
                    ctx = histo_offset + zctx
                    u = reader.read_hybrid_uint(ctx, r, cmap)
                    if u >= (1 << 27):
                        raise JXLError("invalid AC coefficient magnitude")
                    coeff = (u >> 1) if (u & 1) == 0 else -((u + 1) >> 1)
                    qblock[order[k]] += coeff
                    prev = 1 if u else 0
                    remaining -= prev
                    k += 1
                if remaining != 0:
                    raise JXLError("invalid AC block: leftover nzeros")
    if not reader.check_final_state():
        raise JXLError("AC group ANS final state mismatch")


def coefficient_planes(grids, for_card: bool) -> list:
    """Uninitialised i32 planes at each channel's block grid, which the
    native decode fills whole. For a card's render (for_card, CUDA
    present) they are page-locked, from torch's caching host allocator:
    the next frame takes the same pages back, so a frame neither faults
    its 73 MB (12 MP, 4:2:0) in nor loads them through pageable staging."""
    if for_card:
        import torch

        if torch.cuda.is_available():
            return [torch.empty((nby * 8, nbx * 8), dtype=torch.int32,
                                pin_memory=True).numpy()
                    for nby, nbx in grids]
    return [np.empty((nby * 8, nbx * 8), dtype=np.int32)
            for nby, nbx in grids]


def decode_ac_bulk_native_sub(state, data: bytes, per_pass) -> bool:
    """Whole-image AC decode of a subsampled frame: one C call over every
    group section (native/vardct_decode.c decode_ac_image_sub) on
    state.num_threads threads, the coefficients decode_ac_group_sub gives
    written into dense per-channel planes, state.qimg_sub[c] =
    i32[nbyc*8, nbxc*8] at channel c's block grid (each block's 64
    coefficients row-major in its 8x8 tile); state.qblocks_sub stays
    empty. Block contexts conditioned on the DC read state.dc_idx. False,
    with nothing decoded, outside the native scope: no C library, LZ77 or
    prefix codes, more than one pass or histogram set."""
    import os

    from ..base.device import launch_counter
    from ..native_ext import NativeCodes, decode_ac_image_sub_native, \
        get_lib
    from .frame import _bctx_luts, _geometry_luts

    lib = get_lib()
    if lib is None or len(per_pass) != 1 or state.num_histograms != 1:
        return False
    code, cmap = state.ac_code[0], state.ac_context_map[0]
    if code.lz77.enabled or code.use_prefix_code:
        return False
    bcm = state.block_ctx_map
    fd = state.fd
    hs, vs = _shifts(state.fh)
    planes = coefficient_planes(channel_block_grid(fd, hs, vs),
                                getattr(state, "want_qimg", False))
    orders = state.orders[0] if state.orders else {}
    ord_off = np.zeros(3, dtype=np.int64)
    chunks = []
    for c in range(3):
        order = orders.get((acs.STRATEGY_ORDER[acs.DCT], c))
        if order is None:
            order = acs.natural_coeff_order(acs.DCT)
        order = np.asarray(order, dtype=np.int64)
        ord_off[c] = 64 * c
        chunks.append((order // 8) * planes[c].shape[1] + order % 8)
    ord_flat = np.concatenate(chunks).astype(np.int32)
    bctx_lut, qf_thr = _bctx_luts(bcm)
    ncodes = getattr(code, "_native_codes", None)
    if ncodes is None or ncodes.context_map_src is not cmap:
        ncodes = NativeCodes(code, cmap)
        ncodes.context_map_src = cmap
        code._native_codes = ncodes
    offs, sizes = per_pass[0]
    n_threads = min(len(offs), getattr(state, "num_threads", 0)
                    or (os.cpu_count() or 1))
    rc = decode_ac_image_sub_native(
        lib, data, np.asarray(offs, dtype=np.uint64),
        np.asarray(sizes, dtype=np.uint64), fd.xsize_groups,
        fd.group_dim // 8, ncodes,
        np.ascontiguousarray(state.raw_quant_field, dtype=np.int32),
        (bctx_lut, qf_thr, ord_off, ord_flat, _geometry_luts()[3]),
        bcm.num_ctxs, tuple(zip(hs, vs)), planes, n_threads=n_threads,
        dc_idx=getattr(state, "dc_idx", None))
    if rc != 0:
        raise JXLError(f"invalid AC stream (group {rc - 1000})")
    state.qimg_sub = planes
    launch_counter("ac_native_sub").add()
    return True


def dense_planes(state) -> list:
    """Each channel's quantized coefficients as a dense i32 plane at its
    block grid (each block's 64 coefficients row-major in its 8x8 tile):
    state.qimg_sub where the native route filled it, else assembled from
    state.qblocks_sub."""
    planes = getattr(state, "qimg_sub", None)
    if planes is not None:
        return planes
    hs, vs = _shifts(state.fh)
    out = []
    for c, (nby, nbx) in enumerate(channel_block_grid(state.fd, hs, vs)):
        plane5 = np.zeros((nby, 8, nbx, 8), dtype=np.int32)
        d = state.qblocks_sub[c]
        if d:
            keys = np.array(list(d.keys()), dtype=np.int64)
            vals = np.stack([np.asarray(v) for v in d.values()])
            plane5[keys[:, 0], :, keys[:, 1], :] = \
                vals.astype(np.int32).reshape(-1, 8, 8)
        out.append(plane5.reshape(nby * 8, nbx * 8))
    return out


def channel_pixels(state, c: int, q: np.ndarray, sby0: int = 0):
    """Channel c's pixels at its own resolution, f64: dequantization (the
    quant from the luma grid, dec_group.cc:569), the DC, IDCT8 of every
    block of the dense plane q, whose first block row is the channel's
    block row sby0."""
    from ..ops.dct import inv_matrix

    hs, vs = _shifts(state.fh)
    nby, nbx = q.shape[0] // 8, q.shape[1] // 8
    dm = state.matrices.dequant_matrix(acs.QUANT_TABLE[acs.DCT],
                                       c).reshape(8, 8)
    qf = state.raw_quant_field[sby0 << vs[c]::1 << vs[c],
                               ::1 << hs[c]][:nby, :nbx]
    scaled = state.quantizer.inv_global_scale / qf
    blocks = q.reshape(nby, 8, nbx, 8).swapaxes(1, 2)
    co = adjust_quant_bias(blocks, c) * dm * scaled[:, :, None, None]
    co[:, :, 0, 0] = state.dc_sub[c][sby0:sby0 + nby, :nbx]
    # coefficients are stored transposed ([hfreq][vfreq])
    i8 = inv_matrix(8)
    pix = np.einsum("xu,rcvu,yv->rcxy", i8, co, i8)
    return pix.swapaxes(1, 2).reshape(nby * 8, nbx * 8)


def upsample_taps(start: int, n: int, extent: int, shift: int):
    """The source samples of output samples start .. start + n - 1 of a
    channel upsampled by 2 ** shift (libjxl's
    stage_chroma_upsampling.cc): (centre, neighbour) indices into the
    channel, each output 0.75 centre + 0.25 neighbour, the neighbour the
    sample before an even output and after an odd one, an index outside
    the channel's extent replaced by its edge. Outputs past twice the
    extent repeat its last output. shift 0: the samples themselves."""
    o = np.arange(start, start + n)
    if not shift:
        return o, o
    o = np.minimum(o, 2 * extent - 1)
    x = o >> 1
    return x, np.clip(x - 1 + 2 * (o & 1), 0, extent - 1)


def upsample_chroma(plane, hs: int, vs: int, rows, cols, extent,
                    row0: int = 0):
    """plane (a channel's samples from its row row0 on) to the frame's
    resolution: the horizontal stage, then the vertical; rows and cols
    are (start, count) of the output, extent the channel's (rows, cols)
    extent, ceil(ysize / 2 ** vs) x ceil(xsize / 2 ** hs)."""
    if hs:
        x, nb = upsample_taps(*cols, extent[1], hs)
        plane = 0.75 * plane[:, x] + 0.25 * plane[:, nb]
    else:
        plane = plane[:, cols[0]:cols[0] + cols[1]]
    y, nb = upsample_taps(*rows, extent[0], vs)
    if vs:
        return 0.75 * plane[y - row0] + 0.25 * plane[nb - row0]
    return plane[y - row0]


def channel_extent(fd, hs: int, vs: int) -> tuple:
    """A channel's extent at its resolution: (rows, cols)."""
    return -(-fd.ysize >> vs), -(-fd.xsize >> hs)


def render_groups_sub(state) -> None:
    """Per-channel dequant + IDCT at each channel's resolution, then
    libjxl's linear chroma upsampling (stage_chroma_upsampling.cc)."""
    fd = state.fd
    hs, vs = _shifts(state.fh)
    for c, q in enumerate(dense_planes(state)):
        plane = channel_pixels(state, c, q)
        state.xyb[c, :, :] = upsample_chroma(
            plane, hs[c], vs[c], (0, fd.ysize_padded),
            (0, fd.xsize_padded), channel_extent(fd, hs[c], vs[c]))


def tokenize_ac_group_sub(state, group_idx: int, orders: dict = None) -> list:
    """Encoder counterpart of decode_ac_group_sub."""
    fd = state.fd
    hs, vs = _shifts(state.fh)
    gx = group_idx % fd.xsize_groups
    gy = group_idx // fd.xsize_groups
    bx0 = gx * (fd.group_dim // 8)
    by0 = gy * (fd.group_dim // 8)
    bw = min(fd.group_dim // 8, fd.xsize_blocks - bx0)
    bh = min(fd.group_dim // 8, fd.ysize_blocks - by0)
    bcm = state.block_ctx_map
    natural = acs.natural_coeff_order(acs.DCT)
    orders = orders or {}
    ch_orders = [orders.get((acs.STRATEGY_ORDER[acs.DCT], c), natural)
                 for c in range(3)]
    nzeros = [np.zeros(((bh + (1 << vs[c]) - 1) >> vs[c],
                        (bw + (1 << hs[c]) - 1) >> hs[c]), dtype=np.int32)
              for c in range(3)]
    tokens = []
    for by in range(bh):
        for bx in range(bw):
            aby, abx = by0 + by, bx0 + bx
            quant = int(state.raw_quant_field[aby, abx])
            for c in (1, 0, 2):
                sbx = bx >> hs[c]
                sby = by >> vs[c]
                if (sbx << hs[c]) != bx or (sby << vs[c]) != by:
                    continue
                qblock = state.qblocks_sub[c][(aby >> vs[c], abx >> hs[c])]
                flat = np.asarray(qblock).reshape(-1)
                order = ch_orders[c]
                nzv = int(np.count_nonzero(flat[order[1:]]))
                pred = predict_nzeros(nzeros[c][None], 0, sby, sbx)
                block_ctx = bcm.context(0, quant, acs.STRATEGY_ORDER[0], c)
                nz_ctx = bcm.nonzero_context(pred, block_ctx)
                tokens.append(Token(nz_ctx, nzv))
                nzeros[c][sby, sbx] = nzv
                histo_offset = bcm.zero_density_contexts_offset(block_ctx)
                prev = 0 if nzv > 4 else 1
                remaining = nzv
                k = 1
                while k < 64 and remaining != 0:
                    coeff = int(flat[order[k]])
                    u = (coeff << 1) if coeff >= 0 else (-coeff * 2 - 1)
                    ctx = histo_offset + zero_density_context(
                        remaining, k, 1, 0, prev)
                    tokens.append(Token(ctx, u))
                    prev = 1 if u else 0
                    remaining -= prev
                    k += 1
    return tokens


def tokenize_dc_group_sub(state, dc_group_id: int, dec_tree, wp_header):
    """Encoder DC + metadata streams with per-channel dims."""
    fd = state.fd
    hs, vs = _shifts(state.fh)
    vardct_dc, _modular_dc, ac_metadata = _modular_stream_ids(fd)
    x0, y0, rw, rh = fd.dc_group_rect(dc_group_id)
    img = ModularImage(rw, rh, 8, 0)
    for c in (1, 0, 2):
        cw = (rw + (1 << hs[c]) - 1) >> hs[c]
        ch = (rh + (1 << vs[c]) - 1) >> vs[c]
        sx0 = x0 >> hs[c]
        sy0 = y0 >> vs[c]
        fac = state.quantizer.mul_dc(c)
        q = np.round(state.dc_sub[c][sy0:sy0 + ch, sx0:sx0 + cw]
                     / fac).astype(np.int64)
        state.dc_sub[c][sy0:sy0 + ch, sx0:sx0 + cw] = q * fac
        img.channel.append(Channel(cw, ch, hs[c], vs[c],
                                   q.astype(np.int32)))
    dc_tokens = []
    for i in range(3):
        _tokenize_channel(img, i, vardct_dc(dc_group_id), dec_tree,
                          wp_header, dc_tokens)
    # AC metadata (luma grid, DCT8 everywhere)
    blocks = [(acs.DCT, int(state.raw_quant_field[y0 + iy, x0 + ix]))
              for iy in range(rh) for ix in range(rw)]
    count = len(blocks)
    cr_w = -(-rw // 8)
    cr_h = -(-rh // 8)
    from .frame import COLOR_TILE_DIM_IN_BLOCKS

    tx0 = x0 // COLOR_TILE_DIM_IN_BLOCKS
    ty0 = y0 // COLOR_TILE_DIM_IN_BLOCKS
    meta = ModularImage(rw, rh, 8, 0)
    meta.channel = [
        Channel(cr_w, cr_h, 3, 3,
                state.ytox_map[ty0:ty0 + cr_h, tx0:tx0 + cr_w].copy()),
        Channel(cr_w, cr_h, 3, 3,
                state.ytob_map[ty0:ty0 + cr_h, tx0:tx0 + cr_w].copy()),
        Channel(count, 2, 0, 0, np.array(
            [[b[0] for b in blocks], [b[1] - 1 for b in blocks]],
            dtype=np.int32)),
        Channel(rw, rh, 0, 0,
                state.epf_sharpness[y0:y0 + rh, x0:x0 + rw].copy()),
    ]
    meta_tokens = []
    for i in range(4):
        _tokenize_channel(meta, i, ac_metadata(dc_group_id), dec_tree,
                          wp_header, meta_tokens)
    return dc_tokens, meta_tokens, count


def encode_vardct_subsampled(writer: BitWriter, planes, fh,
                             distance: float = 1.0,
                             precomputed: dict = None,
                             matrices_setup=None) -> None:
    """Encode a chroma-subsampled YCbCr frame (DCT8, single pass).

    planes: [Cb, Y, Cr] float arrays in YCbCr units (Y biased by -0.5
    like rgb_to_ycbcr), chroma at its subsampled resolution."""
    from ..entropy.encode import build_and_encode_histograms, write_tokens
    from ..io.toc import write_group_offsets
    from ..modular.codec import GroupHeader
    from ..modular.predict import P_GRADIENT
    from ..modular.tree import encode_tree, make_fixed_tree, \
        num_tree_contexts
    from ..ops.dct import fwd_matrix
    from .frame import K_AC_QUANT, K_DC_QUANT, ORDER_ENC, VarDCTState
    from ..io.fields import u32_write

    fd = fh.frame_dimensions()
    state = VarDCTState(fh, fd)
    hs, vs = _shifts(fh)
    grids = channel_block_grid(fd, hs, vs)
    state.dc_sub = [np.zeros(g, dtype=np.float64) for g in grids]
    state.qblocks_sub = [dict() for _ in range(3)]
    if matrices_setup is not None:
        matrices_setup(state)
    state.strategy[:, :] = acs.DCT
    state.is_origin[:, :] = True
    if fh.loop_filter.epf_iters > 0:
        state.epf_sharpness[:, :] = 4
    if precomputed is not None:
        # JPEG transcode path: integer coefficients + DC arrive directly
        # (ComputeJPEGTranscodingData analog, enc_frame.cc:734)
        state.qblocks_sub = precomputed["qblocks"]
        state.dc_sub = precomputed["dc"]
        state.raw_quant_field[:, :] = 1
        raw_qf = 1
    else:
        quant_ac = K_AC_QUANT / distance
        quant_dc = K_DC_QUANT / distance
        state.quantizer.compute_global_scale_and_quant(quant_dc, quant_ac)
        raw_qf = max(1, min(QUANT_MAX, int(
            quant_ac * state.quantizer.inv_global_scale + 0.5)))
        state.raw_quant_field[:, :] = raw_qf
    inv_gs = state.quantizer.inv_global_scale
    f8 = fwd_matrix(8)
    scaled = inv_gs / raw_qf
    for c in (() if precomputed is not None else range(3)):
        nby, nbx = grids[c]
        dm_inv = state.matrices.inv_matrix(acs.QUANT_TABLE[acs.DCT],
                                           c).reshape(-1)
        plane = np.asarray(planes[c], dtype=np.float64)
        ph, pw = nby * 8, nbx * 8
        plane = np.pad(plane, ((0, ph - plane.shape[0]),
                               (0, pw - plane.shape[1])), mode="edge")
        for sby in range(nby):
            for sbx in range(nbx):
                block = plane[sby * 8:sby * 8 + 8, sbx * 8:sbx * 8 + 8]
                co = (f8 @ block @ f8.T).T  # transposed coefficient layout
                q = np.round(co.reshape(-1) * dm_inv / scaled).astype(
                    np.int64)
                q[0] = 0
                state.qblocks_sub[c][(sby, sbx)] = q
                state.dc_sub[c][sby, sbx] = co[0, 0]
    # modular tree + DC/meta streams
    tree = make_fixed_tree(P_GRADIENT)
    tree_writer = BitWriter()
    dec_tree = encode_tree(tree, tree_writer)
    wp_header = GroupHeader().wp_header
    dc_streams = [tokenize_dc_group_sub(state, g, dec_tree, wp_header)
                  for g in range(fd.num_dc_groups)]
    modular_token_lists = [[]]
    for dc_tokens, meta_tokens, _ in dc_streams:
        modular_token_lists.append(dc_tokens)
        modular_token_lists.append(meta_tokens)
    histo_writer = BitWriter()
    codes, context_map = build_and_encode_histograms(
        modular_token_lists, num_tree_contexts(dec_tree), histo_writer)
    # custom coefficient orders from zero counts (ComputeCoeffOrder
    # analog, enc_coeff_order.cc:84-165); small grids keep defaults
    from .coeff_order import compute_coeff_orders, encode_coeff_orders

    customize = fd.xsize_blocks >= 5 or fd.ysize_blocks >= 5
    ord0 = acs.STRATEGY_ORDER[acs.DCT]
    num_zeros = {(ord0, c): np.zeros(64, dtype=np.int64) for c in range(3)}
    for c in range(3):
        for qblock in state.qblocks_sub[c].values():
            num_zeros[(ord0, c)] += (np.asarray(qblock).reshape(-1) == 0)
    used_orders, orders = compute_coeff_orders(
        num_zeros, {acs.DCT}, customize=customize)
    group_tokens = [tokenize_ac_group_sub(state, g, orders)
                    for g in range(fd.num_groups)]
    ac_histo_writer = BitWriter()
    ac_codes, ac_cmap = build_and_encode_histograms(
        group_tokens, state.block_ctx_map.num_ac_contexts(),
        ac_histo_writer)

    def write_dc_global(w):
        state.matrices.encode_dc(w)
        state.quantizer.encode(w)
        w.write(1, 1)  # default block ctx map
        # explicit all-zero cmap DC: the library default has
        # base_correlation_b = kYToBRatio != 0, which fails the decoder's
        # IsJPEGCompatible() check (chroma_from_luma.h:62-66)
        from ..io.fields import f16_write
        w.write(1, 0)           # not all_default
        w.write(2, 0)           # color factor: Val(kDefaultColorFactor)
        f16_write(0.0, w)       # base_correlation_x
        f16_write(0.0, w)       # base_correlation_b
        w.write(8, 128)         # ytox_dc = 0 (offset by int8 min)
        w.write(8, 128)         # ytob_dc = 0
        w.write(1, 1)  # has global tree
        w.append_bits_from(tree_writer)
        w.append_bits_from(histo_writer)

    def write_dc_group(w, g):
        dc_tokens, meta_tokens, count = dc_streams[g]
        w.write(2, 0)  # extra_precision
        gh = GroupHeader()
        gh.use_global_tree = True
        gh.write(w)
        write_tokens(dc_tokens, codes, context_map, w)
        x0, y0, rw, rh = fd.dc_group_rect(g)
        upper_bound = rw * rh
        nbits = (upper_bound - 1).bit_length() if upper_bound > 1 else 0
        if nbits:
            w.write(nbits, count - 1)
        gh2 = GroupHeader()
        gh2.use_global_tree = True
        gh2.write(w)
        write_tokens(meta_tokens, codes, context_map, w)

    def write_ac_global(w):
        state.matrices.encode(w, num_dc_groups=fd.num_dc_groups)
        nbits = (fd.num_groups - 1).bit_length() if fd.num_groups > 1 else 0
        if nbits:
            w.write(nbits, 0)
        u32_write(ORDER_ENC, used_orders, w)
        encode_coeff_orders(used_orders, orders, w)
        w.append_bits_from(ac_histo_writer)

    sections = []
    single = fd.num_groups == 1
    if single:
        w = BitWriter()
        write_dc_global(w)
        write_dc_group(w, 0)
        write_ac_global(w)
        write_tokens(group_tokens[0], ac_codes, ac_cmap, w)
        sections.append(w.get_bytes())
    else:
        w = BitWriter()
        write_dc_global(w)
        sections.append(w.get_bytes())
        for g in range(fd.num_dc_groups):
            w = BitWriter()
            write_dc_group(w, g)
            sections.append(w.get_bytes())
        w = BitWriter()
        write_ac_global(w)
        sections.append(w.get_bytes())
        for g in range(fd.num_groups):
            w = BitWriter()
            write_tokens(group_tokens[g], ac_codes, ac_cmap, w)
            sections.append(w.get_bytes())
    fh.write(writer)
    write_group_offsets([len(s) for s in sections], None, writer)
    writer.zero_pad_to_byte()
    for s in sections:
        writer.append_bytes(s)
