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
    acs_row = img.channel[2].data[0]
    qf_row = img.channel[2].data[1]
    sharp = img.channel[3].data
    num = 0
    for iy in range(rh):
        for ix in range(rw):
            x, y = x0 + ix, y0 + iy
            s_val = int(sharp[iy, ix])
            if not 0 <= s_val < 8:
                raise JXLError("invalid EPF sharpness")
            state.epf_sharpness[y, x] = s_val
            if state.strategy[y, x] >= 0:
                continue
            if num >= count:
                raise JXLError("AC metadata overflow")
            raw = int(acs_row[num])
            if raw != acs.DCT:
                raise JXLError("subsampled frames support DCT8 only")
            state.strategy[y, x] = raw
            state.is_origin[y, x] = True
            qf = 1 + max(0, min(QUANT_MAX - 1, int(qf_row[num])))
            state.raw_quant_field[y, x] = qf
            num += 1
    if num != count:
        raise JXLError("AC metadata count mismatch")


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
                block_ctx = bcm.context(0, quant, acs.STRATEGY_ORDER[0], c)
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


def render_groups_sub(state) -> None:
    """Per-channel dequant + IDCT at each channel's resolution, then
    chroma upsampling (stage_chroma_upsampling analog: box)."""
    from ..ops.dct import inv_matrix

    fd = state.fd
    hs, vs = _shifts(state.fh)
    inv_gs = state.quantizer.inv_global_scale
    i8 = inv_matrix(8)
    for c in range(3):
        nby = (fd.ysize_blocks + (1 << vs[c]) - 1) >> vs[c]
        nbx = (fd.xsize_blocks + (1 << hs[c]) - 1) >> hs[c]
        dm = state.matrices.dequant_matrix(acs.QUANT_TABLE[acs.DCT],
                                           c).reshape(-1)
        plane = np.zeros((nby * 8, nbx * 8))
        for (sby, sbx), qblock in state.qblocks_sub[c].items():
            # quant comes from the luma grid position (dec_group.cc:569)
            quant = int(state.raw_quant_field[sby << vs[c], sbx << hs[c]])
            scaled = inv_gs / quant
            co = adjust_quant_bias(qblock, c) * dm * scaled
            co = co.reshape(8, 8).copy()
            co[0, 0] = state.dc_sub[c][sby, sbx]
            # coefficients are stored transposed ([hfreq][vfreq])
            pix = i8 @ co.T @ i8.T
            plane[sby * 8:sby * 8 + 8, sbx * 8:sbx * 8 + 8] = pix
        # upsample chroma to luma resolution (nearest/box)
        up = np.repeat(np.repeat(plane, 1 << vs[c], 0), 1 << hs[c], 1)
        state.xyb[c, :, :] = up[:fd.ysize_padded, :fd.xsize_padded]


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
