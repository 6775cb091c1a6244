"""Frame-level codec: section layout, TOC, modular frame encode/decode.

Mirrors the reference frame anatomy (dec_frame.cc, enc_frame.cc):
sections = [DC global | DC groups... | AC global | AC groups x passes],
single-section special case when num_groups == 1 and num_passes == 1
(toc.h:36-41). VarDCT section contents live in libjxl_tpu.vardct.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..base.device import span
from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from ..io.frame_header import (
    CT_NONE,
    CT_XYB,
    ENC_MODULAR,
    ENC_VARDCT,
    FT_REGULAR,
    FrameDimensions,
    FrameHeader,
)
from ..io.toc import read_group_offsets, write_group_offsets
from ..entropy.decode import decode_histograms
from ..entropy.encode import build_and_encode_histograms, write_tokens
from ..modular.codec import (
    GroupHeader,
    ModularOptions,
    _tokenize_channel,
    modular_decode,
)
from ..modular.image import Channel, ModularImage
from ..modular.predict import P_GRADIENT
from ..modular.transforms import Transform, T_RCT, fwd_palette, fwd_rct
from ..modular.tree import (
    decode_tree,
    encode_tree,
    make_fixed_tree,
    num_tree_contexts,
)

NUM_QUANT_TABLES = 17  # quant_weights.h:340


def num_toc_entries(fd: FrameDimensions, num_passes: int) -> int:
    if fd.num_groups == 1 and num_passes == 1:
        return 1
    return 2 + fd.num_dc_groups + fd.num_groups * num_passes


def modular_ac_stream_id(fd: FrameDimensions, group_id: int,
                         pass_id: int) -> int:
    """ModularStreamId::ModularAC (dec_modular.h:62-65)."""
    return (1 + 3 * fd.num_dc_groups + NUM_QUANT_TABLES
            + fd.num_groups * pass_id + group_id)


def modular_dc_stream_id(fd: FrameDimensions, group_id: int) -> int:
    return 1 + fd.num_dc_groups + group_id


GLOBAL_STREAM_ID = 0


@dataclass
class ModularFrameState:
    """Shared state between global info and group decoding (analog of
    ModularFrameDecoder, dec_modular.h:96-150)."""

    full_image: ModularImage = None
    tree: list = None
    code: object = None
    context_map: list = None
    global_header: GroupHeader = None
    have_something: bool = False


def _channel_brackets(image: ModularImage, group_dim: int):
    """Index of first non-meta channel larger than group_dim (beginc):
    channels before it belong to the global stream."""
    c = image.nb_meta_channels
    while c < len(image.channel):
        ch = image.channel[c]
        if ch.w > group_dim or ch.h > group_dim:
            break
        c += 1
    return c


def _group_channel_list(state: ModularFrameState, fd: FrameDimensions,
                        rect, min_shift: int, max_shift: int):
    """Channels (index, sub-rect) contributing to a group stream
    (dec_modular.cc:301-340)."""
    image = state.full_image
    beginc = _channel_brackets(image, fd.group_dim)
    x0, y0, gw, gh = rect
    out = []
    for c in range(beginc, len(image.channel)):
        fc = image.channel[c]
        shift = min(fc.hshift, fc.vshift)
        if shift > max_shift or shift < min_shift:
            continue
        rx0 = x0 >> fc.hshift
        ry0 = y0 >> fc.vshift
        rw = min(gw >> fc.hshift, fc.w - rx0)
        rh = min(gh >> fc.vshift, fc.h - ry0)
        if rw <= 0 or rh <= 0:
            continue
        out.append((c, rx0, ry0, rw, rh))
    return out


# ------------------------------------------------------------------- decoding
def decode_global_info(r: BitReader, fh: FrameHeader, fd: FrameDimensions,
                       state: ModularFrameState) -> None:
    """ModularFrameDecoder::DecodeGlobalInfo (dec_modular.cc:179-298)."""
    m = fh.nonserialized_metadata.m
    decode_color = fh.encoding == ENC_MODULAR
    nb_chans = 3
    if m.color_encoding.is_gray() and fh.color_transform == CT_NONE:
        nb_chans = 1
    nb_extra = len(m.extra_channel_info)
    has_tree = bool(r.read_bits(1))
    if has_tree:
        limit = min(1 << 22,
                    1024 + fd.xsize * fd.ysize * (nb_chans + nb_extra) // 16)
        state.tree = decode_tree(r, limit)
        state.code, state.context_map = decode_histograms(
            r, num_tree_contexts(state.tree))
    if not decode_color:
        nb_chans = 0
    gi = ModularImage(fd.xsize, fd.ysize, m.bit_depth.bits_per_sample,
                      nb_chans + nb_extra)
    if fh.color_transform == 2:  # YCbCr
        for c in range(nb_chans):
            hs = fh.chroma_subsampling.hshift(c)
            vs = fh.chroma_subsampling.vshift(c)
            gi.channel[c] = Channel(-(-fd.xsize // (1 << hs)),
                                    -(-fd.ysize // (1 << vs)), hs, vs)
    for ec in range(nb_extra):
        c = nb_chans + ec
        ecups = fh.extra_channel_upsampling[ec] if fh.extra_channel_upsampling else 1
        w = -(-fd.xsize_upsampled // ecups)
        h = -(-fd.ysize_upsampled // ecups)
        shift = (ecups - 1).bit_length() - (fh.upsampling - 1).bit_length()
        gi.channel[c] = Channel(w, h, shift, shift)
    options = ModularOptions(max_chan_size=fd.group_dim, group_dim=fd.group_dim)
    state.global_header = GroupHeader()
    modular_decode(r, gi, GLOBAL_STREAM_ID, options,
                   global_tree=state.tree, global_code=state.code,
                   global_ctx_map=state.context_map,
                   undo_transforms=False, header=state.global_header)
    state.have_something = any(
        c >= gi.nb_meta_channels and ch.w <= fd.group_dim
        and ch.h <= fd.group_dim
        for c, ch in enumerate(gi.channel))
    state.full_image = gi


def decode_modular_group(r: BitReader, fh: FrameHeader, fd: FrameDimensions,
                         state: ModularFrameState, rect, min_shift: int,
                         max_shift: int, stream_id: int) -> None:
    """ModularFrameDecoder::DecodeGroup (dec_modular.cc:301-410)."""
    chans = _group_channel_list(state, fd, rect, min_shift, max_shift)
    if not chans:
        return
    gi = ModularImage(rect[2], rect[3], state.full_image.bitdepth, 0)
    for (c, rx0, ry0, rw, rh) in chans:
        fc = state.full_image.channel[c]
        gi.channel.append(Channel(rw, rh, fc.hshift, fc.vshift))
    options = ModularOptions()
    modular_decode(r, gi, stream_id, options, global_tree=state.tree,
                   global_code=state.code, global_ctx_map=state.context_map,
                   undo_transforms=True)
    for gc, (c, rx0, ry0, rw, rh) in zip(gi.channel, chans):
        state.full_image.channel[c].data[ry0:ry0 + rh, rx0:rx0 + rw] = gc.data


def finalize_modular_frame(fh: FrameHeader, state: ModularFrameState):
    """Undo global transforms; return full image channels
    (FinalizeFrameDecoding analog)."""
    image = state.full_image
    for t in reversed(image.transform):
        t.inverse(image, state.global_header.wp_header)
    image.transform = []
    return image


def decode_frame_sections(r: BitReader, fh: FrameHeader,
                          decode_dc_global, decode_dc_group,
                          decode_ac_global, decode_ac_group,
                          runner=None, decode_ac_bulk=None) -> None:
    """Reads TOC, dispatches section payloads to the callbacks.

    Callbacks receive a BitReader positioned at their section.
    runner: parallel runner for the independent DC/AC group sections
    (ProcessSections' RunOnPool, dec_frame.cc:568); None = in order.
    The TOC read is a jxl.headers span, and the sections are three spans
    (base/device.span): jxl.frame.dc (DC global and every DC group),
    jxl.frame.ac_global and jxl.frame.ac (the bulk call or every AC
    group).
    """
    fd = fh.frame_dimensions()
    num_passes = fh.passes.num_passes
    n = num_toc_entries(fd, num_passes)
    with span("jxl.headers"):
        offsets, sizes, total = read_group_offsets(n, r)
    r.jump_to_byte_boundary()
    base = r.total_bits_consumed() // 8
    data = r.data

    def section_reader(idx):
        start = base + offsets[idx]
        return BitReader(data[start:start + sizes[idx]])

    if fd.num_groups == 1 and num_passes == 1:
        sr = section_reader(0)
        with span("jxl.frame.dc"):
            decode_dc_global(sr)
            decode_dc_group(0, sr)
        with span("jxl.frame.ac_global"):
            decode_ac_global(sr)
        with span("jxl.frame.ac"):
            decode_ac_group(0, 0, sr)
    else:
        from ..parallel.runner import SequentialRunner

        if runner is None:
            runner = SequentialRunner()
        with span("jxl.frame.dc"):
            decode_dc_global(section_reader(0))
            runner.run([
                (lambda g=g: decode_dc_group(g, section_reader(1 + g)))
                for g in range(fd.num_dc_groups)])
        with span("jxl.frame.ac_global"):
            decode_ac_global(section_reader(1 + fd.num_dc_groups))
        with span("jxl.frame.ac"):
            handled = False
            if decode_ac_bulk is not None:
                # one native call per pass over all group sections
                # (see vardct.frame.decode_ac_bulk_native)
                per_pass = []
                for p in range(num_passes):
                    i0 = 2 + fd.num_dc_groups + p * fd.num_groups
                    per_pass.append((
                        [base + offsets[i0 + g]
                         for g in range(fd.num_groups)],
                        [sizes[i0 + g] for g in range(fd.num_groups)]))
                handled = decode_ac_bulk(data, per_pass)
            if not handled:
                tasks = []
                for p in range(num_passes):
                    for g in range(fd.num_groups):
                        idx = 2 + fd.num_dc_groups + p * fd.num_groups + g
                        tasks.append(
                            lambda g=g, p=p, idx=idx: decode_ac_group(
                                g, p, section_reader(idx)))
                runner.run(tasks)
    # advance the outer reader past all sections
    r.skip_bits(total * 8)


def decode_modular_frame(r: BitReader, fh: FrameHeader,
                         reference_frames=None,
                         reference_extra=None) -> ModularImage:
    """Full modular-mode frame decode (headers already read).

    reference_frames: up to 4 stashed float frames ([0, 1]-normalized
    planes for modular reference frames, matching the reference
    decoder's storage scale) — required when the frame signals the
    kPatches flag (the reference encoder emits patch dictionaries for
    glyph-heavy lossless content, enc_patch_dictionary.cc:594)."""
    fd = fh.frame_dimensions()
    state = ModularFrameState()
    state.patches = None

    def dc_global(sr):
        # image features in reference LfGlobal order: patches, splines,
        # noise (dec_frame.cc:269-292)
        if fh.flags & 2:  # patches
            if reference_frames is None:
                raise JXLError("modular patches need reference frames")
            from ..render.patches import decode_patches

            m = fh.nonserialized_metadata.m
            state.patches = decode_patches(
                sr, fd.xsize_padded, fd.ysize_padded,
                len(m.extra_channel_info), reference_frames)
        if fh.flags & 16:
            raise JXLError("splines not yet supported in modular decode")
        if fh.flags & 1:  # noise
            raise JXLError("noise not yet supported in modular decode")
        # DC dequant factors (quant_weights.cc:507-522): for XYB-coded
        # modular frames they are the int->float scale (dec_modular.cc
        # DCQuants usage), so keep them instead of skipping
        from ..vardct.quant_weights import DequantMatrices

        state.matrices = DequantMatrices()
        state.matrices.decode_dc(sr)
        decode_global_info(sr, fh, fd, state)

    def dc_group(g, sr):
        gx = g % fd.xsize_dc_groups
        gy = g // fd.xsize_dc_groups
        rect = (gx * fd.dc_group_dim, gy * fd.dc_group_dim,
                fd.dc_group_dim, fd.dc_group_dim)
        decode_modular_group(sr, fh, fd, state, rect, 3, 1000,
                             modular_dc_stream_id(fd, g))

    def ac_global(sr):
        pass  # empty for modular frames (dec_frame.cc:367-372)

    def ac_group(g, p, sr):
        gx = g % fd.xsize_groups
        gy = g // fd.xsize_groups
        rect = (gx * fd.group_dim, gy * fd.group_dim, fd.group_dim,
                fd.group_dim)
        min_shift, max_shift = get_downsampling_bracket(fh.passes, p)
        decode_modular_group(sr, fh, fd, state, rect, min_shift, max_shift,
                             modular_ac_stream_id(fd, g, p))

    decode_frame_sections(r, fh, dc_global, dc_group, ac_global, ac_group)
    img = finalize_modular_frame(fh, state)
    img.dc_quant = state.matrices.dc_quant  # XYB int->float scale
    if state.patches is not None:
        _apply_modular_patches(img, state.patches, fh, reference_frames,
                               reference_extra)
    return img


def _apply_modular_patches(img: ModularImage, patches, fh: FrameHeader,
                           reference_frames, reference_extra) -> None:
    """Blend the patch dictionary into a decoded modular frame.

    The reference stores modular reference frames as [0, 1]-normalized
    floats and blends in that space (blending.cc operates on the render
    pipeline's nominal float range); integer results round back exactly
    for the lossless kAdd/kReplace modes the encoder emits."""
    from ..render.patches import apply_patches

    m = fh.nonserialized_metadata.m
    bits = m.bit_depth.bits_per_sample
    maxval = (1 << bits) - 1
    num_ec = len(m.extra_channel_info)
    nb = len(img.channel) - num_ec
    col = np.stack([img.channel[c].data.astype(np.float64)
                    for c in range(nb)]) / maxval
    norm_extras = None
    ec_maxvals = []
    if num_ec:
        ec_maxvals = [
            (1 << m.extra_channel_info[k].bit_depth.bits_per_sample) - 1
            for k in range(num_ec)]
        norm_extras = [
            img.channel[nb + k].data.astype(np.float64) / mv
            for k, mv in enumerate(ec_maxvals)]
    premul = bool(m.extra_channel_info
                  and getattr(m.extra_channel_info[0], "alpha_associated",
                              False))
    apply_patches(col, patches, reference_frames, add=True,
                  extra=norm_extras, ref_extra=reference_extra,
                  alpha_is_premultiplied=premul)
    for c in range(nb):
        img.channel[c].data = np.clip(
            np.round(col[c] * maxval), 0, maxval).astype(
                img.channel[c].data.dtype)
    if norm_extras is not None:
        for k, mv in enumerate(ec_maxvals):
            img.channel[nb + k].data = np.clip(
                np.round(norm_extras[k] * mv), 0, mv).astype(
                    img.channel[nb + k].data.dtype)


def get_downsampling_bracket(passes, pass_idx: int):
    """Passes::GetDownsamplingBracket (frame_header.h:268-284).
    Returns (min_shift, max_shift)."""
    max_shift = 2
    min_shift = 3
    i = 0
    while True:
        for j in range(passes.num_downsample):
            if i == passes.last_pass[j]:
                min_shift = {8: 3, 4: 2, 2: 1, 1: 0}[passes.downsample[j]]
        if i == passes.num_passes - 1:
            min_shift = 0
        if i == pass_idx:
            return min_shift, max_shift
        max_shift = min_shift - 1
        i += 1


# ------------------------------------------------------------------- encoding
@dataclass
class ModularEncOptions:
    group_size_shift: int = 1
    color_transform: int = 6  # RCT type; None = keep raw channels
    predictor: int = P_GRADIENT
    effort: int = 3  # >= 4 learns an MA tree (enc_ma analog)
    tree_sample_step: int = 2
    try_palette: bool = True
    max_palette_colors: int = 256
    lz77: bool = True  # try ApplyLZ77_RLE on the residual token streams
    use_prefix: bool = False  # prefix codes instead of rANS (faster decode)
    delta_palette: bool = False  # lossy delta palette (graphics content)
    responsive: bool = False  # Squeeze pyramid (progressive lossless)


def encode_modular_frame(writer: BitWriter, channels, fh: FrameHeader,
                         options: ModularEncOptions = None) -> None:
    """Encode a modular frame: frame header | TOC | sections.

    channels: list of HxW int32 arrays (already in modular ranges).
    Mirrors enc_modular.cc ComputeEncodingData + enc_frame.cc EncodeGroups.
    """
    if options is None:
        options = ModularEncOptions()
    fd = fh.frame_dimensions()
    # Build the full modular image + global transforms.
    image = ModularImage(fd.xsize, fd.ysize,
                         fh.nonserialized_metadata.m.bit_depth.bits_per_sample)
    image.channel = [Channel(a.shape[1], a.shape[0], data=a.astype(np.int32))
                     for a in channels]
    global_transforms = []
    palette_t = None
    if options.delta_palette and len(channels) >= 1:
        from ..modular.transforms import fwd_delta_palette

        palette_t = fwd_delta_palette(image, 0, min(len(channels), 3),
                                      options.max_palette_colors)
    elif options.try_palette and len(channels) >= 1:
        palette_t = fwd_palette(image, 0, len(channels),
                                options.max_palette_colors)
    if palette_t is not None:
        global_transforms.append(palette_t)
    elif options.color_transform is not None and len(channels) >= 3:
        t = Transform()
        t.id = T_RCT
        t.begin_c = 0
        t.rct_type = options.color_transform
        fwd_rct(image, 0, t.rct_type)
        global_transforms.append(t)
    if options.responsive and palette_t is None:
        # Squeeze pyramid (default parameters): progressive lossless;
        # squeezed residual channels with shift >= 3 land in the DC
        # group streams, giving a 1:8+ early preview (enc_squeeze.cc)
        from ..modular.transforms import (
            T_SQUEEZE,
            default_squeeze_parameters,
            fwd_squeeze,
        )

        sq = Transform()
        sq.id = T_SQUEEZE
        sq.squeezes = []
        params = default_squeeze_parameters(image)
        fwd_squeeze(image, params)
        global_transforms.append(sq)
    image.transform = global_transforms

    if options.effort >= 4 and not getattr(options, "force_predictor",
                                           False):
        from ..modular.learn import learn_tree

        tree = learn_tree(
            [(ch.data, i, 0) for i, ch in enumerate(image.channel)],
            sample_step=options.tree_sample_step)
    else:
        # an explicitly forced predictor (cjxl --modular_predictor)
        # overrides tree learning at every effort
        tree = make_fixed_tree(options.predictor)
    # Tokenize all streams with the decoder-layout tree.
    tree_writer = BitWriter()
    dec_tree = encode_tree(tree, tree_writer)
    header = GroupHeader()
    header.use_global_tree = True
    header.transforms = global_transforms

    streams = []  # (stream_id, tokens, group_header or None)

    # Global stream: channels <= group_dim (none for big images).
    beginc = _channel_brackets(image, fd.group_dim)
    global_tokens = []
    tmp = ModularImage(image.w, image.h, image.bitdepth, 0)
    tmp.nb_meta_channels = image.nb_meta_channels
    tmp.channel = image.channel[:beginc]
    for i in range(len(tmp.channel)):
        _tokenize_channel(tmp, i, GLOBAL_STREAM_ID, dec_tree,
                          header.wp_header, global_tokens)
    streams.append((GLOBAL_STREAM_ID, global_tokens, None))

    state = ModularFrameState()
    state.full_image = image

    group_streams = []  # (kind, group, pass, stream_id, chans)
    for g in range(fd.num_dc_groups):
        gx, gy = g % fd.xsize_dc_groups, g // fd.xsize_dc_groups
        rect = (gx * fd.dc_group_dim, gy * fd.dc_group_dim,
                fd.dc_group_dim, fd.dc_group_dim)
        chans = _group_channel_list(state, fd, rect, 3, 1000)
        group_streams.append(("dc", g, 0, modular_dc_stream_id(fd, g), chans))
    for p in range(fh.passes.num_passes):
        min_shift, max_shift = get_downsampling_bracket(fh.passes, p)
        for g in range(fd.num_groups):
            gx, gy = g % fd.xsize_groups, g // fd.xsize_groups
            rect = (gx * fd.group_dim, gy * fd.group_dim, fd.group_dim,
                    fd.group_dim)
            chans = _group_channel_list(state, fd, rect, min_shift, max_shift)
            group_streams.append(
                ("ac", g, p, modular_ac_stream_id(fd, g, p), chans))

    stream_tokens = {}
    stream_widths = {}
    for kind, g, p, sid, chans in group_streams:
        tokens = []
        width = 0
        if chans:
            gi = ModularImage(1, 1, image.bitdepth, 0)
            for (c, rx0, ry0, rw, rh) in chans:
                fc = image.channel[c]
                gi.channel.append(Channel(
                    rw, rh, fc.hshift, fc.vshift,
                    fc.data[ry0:ry0 + rh, rx0:rx0 + rw].copy()))
                width = max(width, rw)
            for i in range(len(gi.channel)):
                _tokenize_channel(gi, i, sid, dec_tree, header.wp_header,
                                  tokens)
        stream_tokens[sid] = tokens
        stream_widths[sid] = width

    # One histogram set over all streams (two-phase, like
    # ModularFrameEncoder::ComputeEncodingData + EncodeGlobalInfo).
    all_token_lists = [global_tokens] + [stream_tokens[sid]
                                         for _, _, _, sid, _ in group_streams]
    global_width = max((ch.w for ch in tmp.channel), default=0)
    widths = [global_width] + [stream_widths[sid]
                               for _, _, _, sid, _ in group_streams]
    if not options.lz77 or options.use_prefix:
        lz77_method = "none"
    elif options.effort >= 9:
        # shortest-path DP over all matches (enc_ans.cc kOptimal)
        lz77_method = "optimal"
    elif options.effort >= 7:
        # hash-chain match search (enc_ans.cc kLZ77, slow-tier default)
        lz77_method = "lz77"
    elif options.effort <= 1:
        # one-pass tier (enc_fast_lossless.cc analog): RLE without the
        # histogram cost model
        lz77_method = "rle_fast"
    else:
        lz77_method = "rle"
    histo_writer = BitWriter()
    codes, context_map = build_and_encode_histograms(
        all_token_lists, num_tree_contexts(dec_tree), histo_writer,
        lz77_method=lz77_method,
        lz77_dist_symbol=1,  # modular readers have a distance multiplier
        lz77_widths=widths,
        use_prefix=options.use_prefix)
    if codes.lz77_tokens is not None:
        global_tokens = codes.lz77_tokens[0]
        for i, (_, _, _, sid, _) in enumerate(group_streams):
            stream_tokens[sid] = codes.lz77_tokens[1 + i]
    # tokenized cache from the histogram pass, same order as
    # all_token_lists (index 0 = global stream)
    pretok_by_sid = {}
    if codes.tokenized:
        for i, (_, _, _, sid, _) in enumerate(group_streams):
            pretok_by_sid[sid] = codes.tokenized[1 + i]

    # --- assemble sections
    global_has_channels = any(
        ch.w > 0 and ch.h > 0 for ch in image.channel[:beginc])

    def write_dc_global(w):
        w.write(1, 1)  # DequantMatrices::DecodeDC all_default
        w.write(1, 1)  # has global tree
        w.append_bits_from(tree_writer)
        w.append_bits_from(histo_writer)
        gh = GroupHeader()
        gh.use_global_tree = True
        gh.transforms = global_transforms
        gh.write(w)
        if global_has_channels:
            write_tokens(global_tokens, codes, context_map, w,
                         pretok=codes.tokenized[0]
                         if codes.tokenized else None)

    def write_group(w, sid, chans):
        if not chans:
            return
        gh = GroupHeader()
        gh.use_global_tree = True
        gh.write(w)
        write_tokens(stream_tokens[sid], codes, context_map, w,
                     pretok=pretok_by_sid.get(sid))

    single = fd.num_groups == 1 and fh.passes.num_passes == 1
    sections = []
    if single:
        w = BitWriter()
        write_dc_global(w)
        for kind, g, p, sid, chans in group_streams:
            if kind == "dc":
                write_group(w, sid, chans)
        # AC global: empty for modular
        for kind, g, p, sid, chans in group_streams:
            if kind == "ac":
                write_group(w, sid, chans)
        sections.append(w.get_bytes())
    else:
        w = BitWriter()
        write_dc_global(w)
        sections.append(w.get_bytes())
        for kind, g, p, sid, chans in group_streams:
            if kind == "dc":
                w = BitWriter()
                write_group(w, sid, chans)
                sections.append(w.get_bytes())
        sections.append(b"")  # AC global
        for kind, g, p, sid, chans in group_streams:
            if kind == "ac":
                w = BitWriter()
                write_group(w, sid, chans)
                sections.append(w.get_bytes())

    # frame header + TOC + payload
    fh.write(writer)
    write_group_offsets([len(s) for s in sections], None, writer)
    writer.zero_pad_to_byte()
    for s in sections:
        writer.append_bytes(s)


def make_modular_frame_header(metadata, group_size_shift: int = 1,
                              is_last: bool = True) -> FrameHeader:
    fh = FrameHeader(metadata)
    fh.all_default = False
    fh.frame_type = FT_REGULAR
    fh.encoding = ENC_MODULAR
    fh.flags = 0
    fh.color_transform = CT_XYB if metadata.m.xyb_encoded else CT_NONE
    fh.group_size_shift = group_size_shift
    fh.is_last = is_last
    fh.loop_filter.all_default = False
    fh.loop_filter.gab = False
    fh.loop_filter.epf_iters = 0
    return fh
