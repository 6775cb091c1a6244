"""Bounded-memory group-at-a-time VarDCT decode.

Mirrors the reference's low-memory render pipeline scheduling
(lib/jxl/render_pipeline/low_memory_render_pipeline.{h,cc}:27-80,
dec_group_border.h:19): the image is decoded one AC-group ROW at a time
— entropy decode the row's sections via TOC random access, dequant+IDCT
into a strip, run the filter chain over a 3-strip rolling window with an
8px halo (covering the gaborish(1) + EPF pass radii 3+2+1), and emit the
finished rows. Peak pixel memory is O(3 group rows x width) plus the DC
/ per-block fields (1/64 area), never the full image.

Strips are AC-group rows, so every transform (<= 256x256 px) is fully
contained in its strip; filters at interior strip edges read real
neighbor data from the window, and at frame edges the same symmetric
mirroring as the whole-image path (render/pipeline.py
mirror_fill_padding, image_ops.h:184 Mirror). Noise synthesis is seeded
per AC group (PrepareNoiseInput), so it reproduces exactly per strip.

Progressive passes (all passes of a row entropy-decode before it
renders), 2-8x upsampling (strip-wise, exact seam context) and
subsampled YCbCr (per-channel strip render, then libjxl's linear chroma
upsampling with one chroma row of each neighbouring strip, so a row is
decoded one ahead) are supported. Features needing whole-image context
(patches, splines, extra channels, animation blending) raise JXLError;
callers fall back to the regular decoder.

Device strips: with a torch device, a stream inside the device scope
(XYB, all-DCT8, no extra channels, noise, upsampling, patches or
splines, default CfL) renders each haloed strip through the single-image
device render, ops/pipeline.decode_render_image (dequant_idct8, the
true-size mirror, render_tail to sRGB u8): two kernel launches a strip
on a CUDA device.
"""

from __future__ import annotations

import numpy as np

from ..base.status import JXLError
from ..io.bits import BitReader

_HALO = 8  # px; > gaborish(1) + epf0(3) + epf1(2) + epf2(1)


class _StripView:
    """State proxy for render_groups: identical attributes, sliced to one
    group row with strip-local block coordinates."""


def _render_strip(state, gy):
    from .frame import render_groups

    fd = state.fd
    gdim_b = fd.group_dim // 8
    by0 = gy * gdim_b
    by1 = min(by0 + gdim_b, fd.ysize_blocks)
    p = _StripView()
    p.fd = fd
    p.qblocks = {(by - by0, bx): v
                 for (by, bx), v in state.qblocks.items()}
    p.strategy = state.strategy[by0:by1]
    p.raw_quant_field = state.raw_quant_field[by0:by1]
    p.dc = state.dc[:, by0:by1]
    # group rows (32 blocks) align with CfL tile rows (8 blocks)
    t0, t1 = by0 // 8, -(-by1 // 8)
    p.ytox_map = state.ytox_map[t0:t1]
    p.ytob_map = state.ytob_map[t0:t1]
    p.ytox = state.ytox
    p.ytob = state.ytob
    p.matrices = state.matrices
    p.quantizer = state.quantizer
    p.x_dm_mult = state.x_dm_mult
    p.b_dm_mult = state.b_dm_mult
    p.xyb = np.zeros((3, (by1 - by0) * 8, fd.xsize_padded),
                     dtype=np.float64)
    render_groups(p)
    return p.xyb


def _filter_strip(comp, fh, state, comp_y0):
    """Mirror frame-edge padding, then gaborish + EPF over one composite
    (halo + strip + halo), exactly like apply_restoration on the whole
    image (render/pipeline.py:178)."""
    from ..render.pipeline import (
        apply_epf,
        apply_gaborish,
        compute_sigma,
        mirror_fill_padding,
    )

    fd = state.fd
    lf = fh.loop_filter
    comp = mirror_fill_padding(
        np.array(comp), min(comp.shape[1], fd.ysize - comp_y0), fd.xsize)
    if lf.gab:
        comp = apply_gaborish(comp, lf)
    if lf.epf_iters > 0:
        b0 = comp_y0 // 8
        b1 = b0 + comp.shape[1] // 8
        inv_sigma = compute_sigma(lf, state.quantizer.global_scale_float,
                                  state.raw_quant_field[b0:b1],
                                  state.epf_sharpness[b0:b1])
        comp = apply_epf(comp, lf, inv_sigma)
    return comp


def _add_strip_noise(state, strip, gy):
    """Noise synthesis for one strip: the per-group xorshift fields are
    exactly reproducible (seeded by group origin), but ConvolveNoise is
    a 5x5 stencil, so the strip's planes carry a 2-row halo from the
    neighboring group rows before convolution."""
    from ..render.noise import add_noise, convolve_noise, random_3planes

    fd = state.fd
    rows = strip.shape[1]
    nrows_g = fd.ysize_groups
    hal_top = 2 if gy > 0 else 0
    hal_bot = 2 if gy + 1 < nrows_g else 0
    comp_rows = rows + hal_top + hal_bot
    planes = [np.zeros((comp_rows, fd.xsize_padded), dtype=np.float32)
              for _ in range(3)]
    for gyy in (gy - 1, gy, gy + 1):
        if not (0 <= gyy < nrows_g):
            continue
        for gx in range(fd.xsize_groups):
            g = gyy * fd.xsize_groups + gx
            gx0, gy0, gw, gh = fd.group_rect(g)
            ps = random_3planes(1, 0, gx0, gy0, gw, gh)
            # group rows mapped into the haloed composite
            if gyy == gy - 1:
                dst0, src0, n = 0, gh - hal_top, hal_top
            elif gyy == gy:
                dst0, src0, n = hal_top, 0, gh
            else:
                dst0, src0, n = hal_top + rows, 0, hal_bot
            if n <= 0:
                continue
            for c in range(3):
                planes[c][dst0:dst0 + n, gx0:gx0 + gw] = \
                    ps[c][src0:src0 + n]
    conv = [convolve_noise(p)[hal_top:hal_top + rows] for p in planes]
    return add_noise(strip, conv, state.noise_lut,
                     state.ytox(state.ytox_dc),
                     state.ytob(state.ytob_dc), preconvolved=True)


def _render_strip_sub(state, gy):
    """Subsampled-YCbCr strip render: per-channel dequant + IDCT8 at each
    channel's resolution for this group row only (render_groups_sub
    restricted to the row). qblocks_sub holds only the current row's
    blocks (cleared per row), keyed by GLOBAL (sby, sbx). Returns each
    channel's pixel rows at its own resolution, [(first row, f64 rows)];
    _upsample_strip_sub takes them to the frame's resolution."""
    from .subsampled import _shifts, channel_pixels

    fd = state.fd
    hs, vs = _shifts(state.fh)
    gdim_b = fd.group_dim // 8
    by0 = gy * gdim_b
    by1 = min(by0 + gdim_b, fd.ysize_blocks)
    out = []
    for c in range(3):
        cb0 = by0 >> vs[c]
        cb1 = -(-by1 >> vs[c])
        nbx = (fd.xsize_blocks + (1 << hs[c]) - 1) >> hs[c]
        plane5 = np.zeros((cb1 - cb0, 8, nbx, 8), dtype=np.int32)
        for (sby, sbx), qblock in state.qblocks_sub[c].items():
            if cb0 <= sby < cb1:
                plane5[sby - cb0, :, sbx, :] = \
                    np.asarray(qblock).reshape(8, 8)
        q = plane5.reshape((cb1 - cb0) * 8, nbx * 8)
        out.append((cb0 * 8, channel_pixels(state, c, q, cb0)))
    return out


def _upsample_strip_sub(state, gy, prev, cur, nxt):
    """The frame-resolution strip of group row gy (3, rows, xsize_padded)
    from the channel rows of rows gy - 1, gy and gy + 1 (_render_strip_sub;
    None past the frame): libjxl's linear chroma upsampling reads one
    channel row beyond the strip at each seam, so a strip equals the
    whole-image render's rows."""
    from .subsampled import _shifts, channel_extent, upsample_chroma

    fd = state.fd
    hs, vs = _shifts(state.fh)
    gdim = fd.group_dim
    y0 = gy * gdim
    rows = min(gdim, fd.ysize_padded - y0)
    out = np.zeros((3, rows, fd.xsize_padded), dtype=np.float64)
    for c in range(3):
        row0, plane = cur[c]
        parts = [plane]
        if prev is not None:
            parts.insert(0, prev[c][1][-1:])
            row0 -= 1
        if nxt is not None:
            parts.append(nxt[c][1][:1])
        out[c] = upsample_chroma(
            np.concatenate(parts), hs[c], vs[c], (y0, rows),
            (0, fd.xsize_padded), channel_extent(fd, hs[c], vs[c]), row0)
    return out


def _strip_qimg(state, gy):
    """Dense image-layout i32 coefficients for one all-DCT8 group row."""
    fd = state.fd
    gdim_b = fd.group_dim // 8
    by0 = gy * gdim_b
    by1 = min(by0 + gdim_b, fd.ysize_blocks)
    nby, nbx = by1 - by0, fd.xsize_blocks
    plane5 = np.zeros((3, nby, 8, nbx, 8), dtype=np.int32)
    if state.qblocks:
        keys = np.array(list(state.qblocks.keys()), dtype=np.int64)
        vals = np.stack([np.asarray(v) for v in
                         state.qblocks.values()]).astype(np.int32)
        plane5[:, keys[:, 0] - by0, :, keys[:, 1], :] = \
            vals.reshape(-1, 3, 8, 8)
    return plane5.reshape(3, nby * 8, nbx * 8)


_HALO_B = 8  # block rows of device-strip halo (64 px, CfL-tile aligned)


def _device_strip_emitter(state, fh, device):
    """Returns emit(prev_q, cur_q, nxt_q, gy) -> u8 rows for the strip,
    rendering the haloed composite on `device` with the SAME function as
    the whole-image device decode (ops/pipeline.decode_render_image):
    dequant + IDCT8 (dequant_idct8), the mirror at the frame edge, then
    Gaborish + EPF + sRGB u8 (render_tail). The 64-px halo exceeds the
    filters' 7-px reach, so the strip rows are those of the whole image.
    Each strip runs the "dec_image" program (api/tpu_codec.render_image),
    so the strips of one shape replay one CUDA graph."""
    from ..api.tpu_codec import render_image
    from ..ops.staging import (block_sigma, dequant_tables, f32,
                               gab_kernels, sad_mul, to_device)

    fd = state.fd
    lf = fh.loop_filter
    gdim_b = fd.group_dim // 8
    w = fd.xsize_blocks * 8
    # per block: the strip takes its rows of the frame's sigma
    inv_sigma_all = block_sigma(state, lf)
    dm, gabk = to_device((dequant_tables(state), gab_kernels(lf)), device)
    igs = f32(state.quantizer.inv_global_scale)
    xdm = f32(state.x_dm_mult)
    bdm = f32(state.b_dm_mult)
    cs = tuple(f32(v) for v in lf.epf_channel_scale)
    p0 = f32(lf.epf_pass0_sigma_scale)
    p2 = f32(lf.epf_pass2_sigma_scale)

    def emit(prev_q, cur_q, nxt_q, gy):
        top_b = _HALO_B if prev_q is not None else 0
        bot_b = _HALO_B if nxt_q is not None else 0
        parts = []
        if top_b:
            parts.append(prev_q[:, -top_b * 8:])
        parts.append(cur_q)
        if bot_b:
            parts.append(nxt_q[:, :bot_b * 8])
        comp = np.ascontiguousarray(np.concatenate(parts, axis=1)) \
            if len(parts) > 1 else parts[0]
        comp_by0 = gy * gdim_b - top_b
        comp_nby = comp.shape[1] // 8
        b0, b1 = comp_by0, comp_by0 + comp_nby
        t0, t1 = b0 // 8, -(-b1 // 8)
        comp_h = comp_nby * 8
        comp_y0 = b0 * 8
        th = min(comp_h, fd.ysize - comp_y0)
        ts = (th, fd.xsize) if (th, fd.xsize) != (comp_h, w) else None
        args = (comp, state.raw_quant_field[b0:b1].astype(np.int32),
                state.dc[:, b0:b1].astype(np.float32),
                state.ytox_map[t0:t1].astype(np.int32),
                state.ytob_map[t0:t1].astype(np.int32), dm, igs, xdm, bdm,
                gabk, inv_sigma_all[b0:b1], sad_mul(lf, comp_h, w), cs,
                int(lf.epf_iters))
        kw = dict(to_rgb="u8srgb", pass0_sigma_scale=p0,
                  pass2_sigma_scale=p2, true_size=ts, extra_tiles=None,
                  tile_shapes=None, size_passes=None, size_shapes=None,
                  class_map=None)
        u8 = render_image(args, kw, device)
        rows = cur_q.shape[1]
        return u8[top_b * 8:top_b * 8 + rows]

    return emit


def decode_vardct_strips(r: BitReader, fh, num_threads: int = 0,
                         device=None, reference_frames=None,
                         reference_extra=None):
    """Generator of (y0, strip) top to bottom: strip is either
    xyb f64[3, rows, xsize] (host render) or uint8[rows, xsize, 3]
    (device render — the strip composite runs through the same function
    as the whole-image device decode).

    device: None renders on the host; a torch device ("cuda": a missing
    card raises; "cpu": the kernels' plain twins) renders the strips of a
    stream inside the device scope there, and those of any other stream
    on the host.

    The reader must be positioned after the frame header. Unsupported
    features raise JXLError (caller falls back to decode_vardct_frame).
    """
    from ..api.frame import (
        decode_global_info,
        decode_modular_group,
        modular_ac_stream_id,
        modular_dc_stream_id,
        ModularFrameState,
        num_toc_entries,
    )
    from ..io.frame_header import (
        CT_XYB,
        CT_YCBCR,
        FLAG_NOISE,
        FLAG_PATCHES,
        FLAG_SPLINES,
        FLAG_USE_DC_FRAME,
    )
    from ..io.toc import read_group_offsets
    from .frame import (
        VarDCTState,
        decode_ac_global,
        decode_ac_group,
        decode_cmap_dc,
        decode_dc_group,
        read_block_ctx_map,
    )

    m = fh.nonserialized_metadata.m
    subsampled = (fh.color_transform == CT_YCBCR
                  and not fh.chroma_subsampling.is_444())
    num_ec = m.num_extra_channels
    if num_ec:
        # extra channels ride per-AC-group modular streams and emit
        # row-wise; global transforms / upsampling need whole-image
        # context and fall back loudly below
        if fh.upsampling != 1:
            raise JXLError("low-memory decode: extra channels + "
                           "upsampling")
        if fh.extra_channel_upsampling and any(
                u != 1 for u in fh.extra_channel_upsampling):
            raise JXLError("low-memory decode: ec_upsampling")
    if fh.flags & FLAG_PATCHES:
        if reference_frames is None or fh.upsampling != 1:
            raise JXLError("low-memory decode: patches need decoded "
                           "reference frames and no upsampling")
    if (fh.flags & FLAG_SPLINES) and fh.upsampling != 1:
        # upsample context rows would need spline-added neighbor data
        raise JXLError("low-memory decode: splines + upsampling")
    if fh.flags & FLAG_USE_DC_FRAME:
        raise JXLError("low-memory decode: DC frames")

    fd = fh.frame_dimensions()
    state = VarDCTState(fh, fd, alloc_xyb=False)
    state.num_threads = num_threads
    mstate = ModularFrameState()
    num_passes = fh.passes.num_passes
    if subsampled:
        from .subsampled import _shifts, channel_block_grid

        hs_, vs_ = _shifts(fh)
        grids = channel_block_grid(fd, hs_, vs_)
        state.dc_sub = [np.zeros(g, dtype=np.float64) for g in grids]
        state.qblocks_sub = [dict() for _ in range(3)]

    n = num_toc_entries(fd, num_passes)
    offsets, sizes, total = read_group_offsets(n, r)
    r.jump_to_byte_boundary()
    base = r.total_bits_consumed() // 8
    data = r.data

    def section_reader(idx):
        start = base + offsets[idx]
        return BitReader(data[start:start + sizes[idx]])

    def dc_global(sr):
        if fh.flags & FLAG_PATCHES:
            from ..render.patches import decode_patches, uses_alpha

            state.patches = decode_patches(
                sr, fd.xsize_padded, fd.ysize_padded, num_ec,
                reference_frames)
            if any(uses_alpha(info.mode) or (i > 0 and info.mode != 0)
                   for blend in state.patches.blendings
                   for i, info in enumerate(blend)):
                raise JXLError("low-memory decode: alpha-blend patches")
        if fh.flags & FLAG_SPLINES:
            from ..render.splines import decode_splines

            state.splines = decode_splines(sr, fd.xsize * fd.ysize)
        if fh.flags & FLAG_NOISE:
            from ..render.noise import decode_noise

            state.noise_lut = decode_noise(sr)
        state.matrices.decode_dc(sr)
        state.quantizer.decode(sr)
        read_block_ctx_map(sr, state)
        decode_cmap_dc(sr, state)
        decode_global_info(sr, fh, fd, mstate)
        state.tree = mstate.tree
        state.code = mstate.code
        state.context_map = mstate.context_map

    def dc_group(g, sr):
        if subsampled:
            from .subsampled import decode_dc_group_sub

            decode_dc_group_sub(sr, state, g)
        else:
            decode_dc_group(sr, state, g)
        gx = g % fd.xsize_dc_groups
        gy = g // fd.xsize_dc_groups
        rect = (gx * fd.dc_group_dim, gy * fd.dc_group_dim,
                fd.dc_group_dim, fd.dc_group_dim)
        decode_modular_group(sr, fh, fd, mstate, rect, 3, 1000,
                             modular_dc_stream_id(fd, g))

    single = fd.num_groups == 1 and num_passes == 1
    if single:
        sr = section_reader(0)
        dc_global(sr)
        dc_group(0, sr)
        decode_ac_global(sr, state)
        row_reader = {0: sr}
    else:
        dc_global(section_reader(0))
        for g in range(fd.num_dc_groups):
            dc_group(g, section_reader(1 + g))
        decode_ac_global(section_reader(1 + fd.num_dc_groups), state)
        row_reader = None

    lf = fh.loop_filter
    filtered = lf.gab or lf.epf_iters > 0
    from ..io.frame_header import CT_XYB

    ups = fh.upsampling
    if ups > 1:
        if state.noise_lut is not None:
            # noise is added at coded resolution before upsampling; the
            # strip's upsample context rows would need noise-applied
            # neighbor data — unsupported combination, loud fallback
            raise JXLError("low-memory decode: noise + upsampling")
        from ..render.upsample import kernels_from_metadata, upsample

        up_kern = kernels_from_metadata(fh.nonserialized_metadata, ups)
    # filter-chain radius is 7 px (gab 1 + EPF 3+2+1); with upsampling
    # the strip also needs 2 EXACT filtered context rows for the 5x5
    # upsample kernels, so the rolling halo grows (8-block aligned for
    # the per-block sigma slicing in _filter_strip)
    halo_px = 16 if ups > 1 else _HALO

    if device is not None:
        from ..base.device import resolve_device

        device = resolve_device(device)
    on_device = bool(
        device is not None and fh.color_transform == CT_XYB and num_ec == 0
        and state.noise_lut is None and ups == 1
        and not (fh.flags & (FLAG_PATCHES | FLAG_SPLINES))
        and np.all(state.strategy[state.is_origin] == _acs().DCT)
        and getattr(state, "color_factor", 84) == 84
        and getattr(state, "base_x", 0.0) == 0.0
        and getattr(state, "base_b", 1.0) == 1.0)

    def decode_row_blocks(gy):
        # all passes for this group row before rendering: progressive
        # coefficients accumulate per block (dec_frame.cc pass loop)
        for p in range(num_passes):
            for gx in range(fd.xsize_groups):
                g = gy * fd.xsize_groups + gx
                sr = row_reader[0] if single \
                    else section_reader(
                        2 + fd.num_dc_groups + p * fd.num_groups + g)
                if subsampled:
                    from .subsampled import decode_ac_group_sub

                    decode_ac_group_sub(sr, state, g, p)
                else:
                    decode_ac_group(sr, state, g, p)
                if num_ec:
                    from ..api.frame import get_downsampling_bracket

                    gx0 = (g % fd.xsize_groups) * fd.group_dim
                    gy0 = (g // fd.xsize_groups) * fd.group_dim
                    mn, mx = get_downsampling_bracket(fh.passes, p)
                    decode_modular_group(
                        sr, fh, fd, mstate,
                        (gx0, gy0, fd.group_dim, fd.group_dim), mn, mx,
                        modular_ac_stream_id(fd, g, p))

    def ec_rows(y0, emit):
        if not num_ec or mstate.full_image is None:
            return None
        if mstate.full_image.transform:
            raise JXLError("low-memory decode: global EC transforms")
        if mstate.full_image.nb_meta_channels:
            raise JXLError("low-memory decode: EC meta channels")
        return [ch.data[y0:y0 + emit, :fd.xsize]
                for ch in mstate.full_image.channel]

    def finish_row(gy):
        if subsampled:
            strip = _render_strip_sub(state, gy)
            for d in state.qblocks_sub:
                d.clear()
        else:
            strip = _strip_qimg(state, gy) if on_device \
                else _render_strip(state, gy)
        state.qblocks.clear()
        cache = getattr(state, "_ac_native", None)
        if cache is not None:
            cache.clear()
        return strip

    channel_rows = {}

    def decode_row(gy):
        if not subsampled:
            decode_row_blocks(gy)
            return finish_row(gy)
        # the strip's last rows upsample from the next row's first
        # channel row: decode one group row ahead
        for k in (gy, gy + 1):
            if k < fd.ysize_groups and k not in channel_rows:
                decode_row_blocks(k)
                channel_rows[k] = finish_row(k)
        channel_rows.pop(gy - 2, None)
        return _upsample_strip_sub(state, gy, channel_rows.get(gy - 1),
                                   channel_rows[gy],
                                   channel_rows.get(gy + 1))

    emitter = _device_strip_emitter(state, fh, device) \
        if on_device else None
    segments_cache = None
    nrows = fd.ysize_groups
    prev = None
    cur = decode_row(0)
    for gy in range(nrows):
        nxt = decode_row(gy + 1) if gy + 1 < nrows else None
        y0 = gy * fd.group_dim
        rows = cur.shape[1]
        if on_device:
            u8 = emitter(prev, cur, nxt, gy)
            emit = min(rows, fd.ysize - y0)
            if emit > 0:
                yield y0, u8[:emit, :fd.xsize]
            prev, cur = cur, nxt
            continue
        out = None
        if filtered:
            top = prev[:, -halo_px:] if prev is not None else None
            bot = nxt[:, :halo_px] if nxt is not None else None
            comp = np.concatenate(
                [p for p in (top, cur, bot) if p is not None], axis=1)
            comp_y0 = y0 - (halo_px if prev is not None else 0)
            out = _filter_strip(comp, fh, state, comp_y0)
            off = halo_px if prev is not None else 0
            strip = out[:, off:off + rows]
        else:
            strip = cur
        if ups > 1:
            # upsample the strip at coded resolution -> output rows.
            # 5x5 kernels need 2 rows of exact context on each interior
            # seam; frame edges pad symmetric exactly like the
            # whole-image stage (render/upsample.py upsample)
            emit = min(rows, fd.ysize - y0)
            if emit <= 0:
                prev, cur = cur, nxt
                continue
            bot_avail = fd.ysize - (y0 + emit)
            top_ctx = 2 if prev is not None else 0
            bot_ctx = min(2, max(0, bot_avail)) if nxt is not None else 0
            if filtered:
                src = out[:, off - top_ctx:off + emit + bot_ctx]
            else:
                parts = []
                if top_ctx:
                    parts.append(prev[:, -top_ctx:])
                parts.append(cur[:, :emit])
                if bot_ctx:
                    parts.append(nxt[:, :bot_ctx])
                src = np.concatenate(parts, axis=1) if len(parts) > 1 \
                    else parts[0]
            src = src[:, :, :fd.xsize]
            up = np.stack([upsample(src[c], ups, kernels=up_kern)
                           for c in range(3)])
            up = up[:, top_ctx * ups:top_ctx * ups + emit * ups,
                    :fd.xsize_upsampled]
            oy0 = y0 * ups
            ocut = min(up.shape[1], fd.ysize_upsampled - oy0)
            if ocut > 0:
                yield oy0, up[:, :ocut]
            prev, cur = cur, nxt
            continue
        if getattr(state, "patches", None) is not None:
            # bounded additive/replace rects: blend the placements
            # overlapping this strip in strip-local coordinates
            # (decoder stage order: restoration -> patches -> splines)
            from ..render.patches import apply_patches

            strip = np.array(strip)
            apply_patches(strip, state.patches, reference_frames,
                          add=True, ref_extra=reference_extra,
                          y_window=(y0, y0 + rows))
        if getattr(state, "splines", None) is not None:
            # additive Gaussian segments with bounded extent: draw the
            # ones overlapping this strip in strip-local coordinates
            # (draw runs AFTER the filter chain, like the whole-image
            # stage order; halos stay pre-spline, so draw on a copy)
            from ..render.splines import draw_segments

            if segments_cache is None:
                from ..render.splines import compute_segments

                segments_cache = compute_segments(
                    state.splines, fd.xsize_padded, fd.ysize_padded,
                    y_to_x=state.ytox(0), y_to_b=state.ytob(0))
            local = [(cx, cy - y0, col, inv, s4i, md)
                     for (cx, cy, col, inv, s4i, md) in segments_cache
                     if y0 - md <= cy <= y0 + rows + md]
            if local:
                strip = np.array(strip)
                draw_segments(strip, local, add=True)
        if state.noise_lut is not None:
            strip = _add_strip_noise(state, np.ascontiguousarray(strip),
                                     gy)
        emit = min(rows, fd.ysize - y0)
        if emit > 0:
            if num_ec:
                yield y0, strip[:, :emit, :fd.xsize], ec_rows(y0, emit)
            else:
                yield y0, strip[:, :emit, :fd.xsize]
        prev, cur = cur, nxt
    r.skip_bits(total * 8)


def _acs():
    from . import ac_strategy as acs

    return acs
