"""Frame-level codec: section layout, TOC, the modular sub-streams that a
VarDCT frame carries (global info, DC groups).

Mirrors the reference frame anatomy (dec_frame.cc, enc_frame.cc):
sections = [DC global | DC groups... | AC global | AC groups x passes],
single-section special case when num_groups == 1 and num_passes == 1
(toc.h:36-41). VarDCT section contents live in libjxl_tpu.vardct.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..io.bits import BitReader
from ..io.frame_header import (
    CT_NONE,
    ENC_MODULAR,
    FrameDimensions,
    FrameHeader,
)
from ..io.toc import read_group_offsets
from ..entropy.decode import decode_histograms
from ..modular.codec import GroupHeader, ModularOptions, modular_decode
from ..modular.image import Channel, ModularImage
from ..modular.tree import decode_tree, num_tree_contexts

def num_toc_entries(fd: FrameDimensions, num_passes: int) -> int:
    if fd.num_groups == 1 and num_passes == 1:
        return 1
    return 2 + fd.num_dc_groups + fd.num_groups * num_passes


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
                   header=state.global_header)
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
                   global_code=state.code, global_ctx_map=state.context_map)
    for gc, (c, rx0, ry0, rw, rh) in zip(gi.channel, chans):
        state.full_image.channel[c].data[ry0:ry0 + rh, rx0:rx0 + rw] = gc.data


def decode_frame_sections(r: BitReader, fh: FrameHeader,
                          decode_dc_global, decode_dc_group,
                          decode_ac_global, decode_ac_group,
                          decode_ac_bulk=None) -> None:
    """Reads TOC, dispatches section payloads to the callbacks, in order.

    Callbacks receive a BitReader positioned at their section.
    """
    fd = fh.frame_dimensions()
    num_passes = fh.passes.num_passes
    n = num_toc_entries(fd, num_passes)
    offsets, sizes, total = read_group_offsets(n, r)
    r.jump_to_byte_boundary()
    base = r.total_bits_consumed() // 8
    data = r.data

    def section_reader(idx):
        start = base + offsets[idx]
        return BitReader(data[start:start + sizes[idx]])

    if fd.num_groups == 1 and num_passes == 1:
        sr = section_reader(0)
        decode_dc_global(sr)
        decode_dc_group(0, sr)
        decode_ac_global(sr)
        decode_ac_group(0, 0, sr)
    else:
        decode_dc_global(section_reader(0))
        for g in range(fd.num_dc_groups):
            decode_dc_group(g, section_reader(1 + g))
        decode_ac_global(section_reader(1 + fd.num_dc_groups))
        handled = False
        if decode_ac_bulk is not None:
            # one native call per pass over all group sections
            # (see vardct.frame.decode_ac_bulk_native)
            per_pass = []
            for p in range(num_passes):
                i0 = 2 + fd.num_dc_groups + p * fd.num_groups
                per_pass.append((
                    [base + offsets[i0 + g] for g in range(fd.num_groups)],
                    [sizes[i0 + g] for g in range(fd.num_groups)]))
            handled = decode_ac_bulk(data, per_pass)
        if not handled:
            for p in range(num_passes):
                for g in range(fd.num_groups):
                    idx = 2 + fd.num_dc_groups + p * fd.num_groups + g
                    decode_ac_group(g, p, section_reader(idx))
    # advance the outer reader past all sections
    r.skip_bits(total * 8)

