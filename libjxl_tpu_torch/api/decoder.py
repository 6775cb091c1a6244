"""Suspendable, event-driven decoder (the JxlDecoder state machine).

Mirrors the public C API protocol of lib/include/jxl/decode.h:122-337,599:
the caller feeds bytes incrementally (`set_input` / `release_input`),
loops on `process()`, and receives events in emission order —
``BASIC_INFO``, ``COLOR_ENCODING``, ``FRAME``, ``FULL_IMAGE``,
``SUCCESS`` — or ``NEED_MORE_INPUT`` when the stream ran dry.
``flush_image()`` renders the best partial image from the sections that
have fully arrived (dec_frame.h:88-99 kPartial sections +
JxlDecoderFlushImage, decode.h:1449): DC-only preview first, then
progressively complete AC groups. ``rewind()`` / ``skip_frames()``
follow decode.h:393-427.

Section-granular resume: headers are cheap and re-parsed on each attempt
until complete; frame sections (TOC-delimited) are decoded exactly once,
as soon as all their bytes are available.

Device: the per-section incremental paths render on the host, as in the
JAX package; the whole-stream fallback decodes through
api.codestream.decode on the decoder's device ("cuda" by default: a
missing card raises there; "cpu" the kernels' plain twins; None the host
decode).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..base.status import JXLError
from ..io.bits import BitReader
from ..io.container import CODESTREAM_SIGNATURE, is_container, parse_boxes
from ..io.frame_header import FT_DC, FT_REFERENCE_ONLY, FrameHeader
from .codestream import parse_codestream_header

# Events (decode.h:122-337)
SUCCESS = "success"
ERROR = "error"
NEED_MORE_INPUT = "need_more_input"
BASIC_INFO = "basic_info"
COLOR_ENCODING = "color_encoding"
FRAME = "frame"
FULL_IMAGE = "full_image"
PREVIEW_IMAGE = "preview_image"          # JXL_DEC_PREVIEW_IMAGE (:219)
BOX = "box"                              # JXL_DEC_BOX (:270)
FRAME_PROGRESSION = "frame_progression"  # JXL_DEC_FRAME_PROGRESSION
# JXL_DEC_JPEG_RECONSTRUCTION (:243): fires when a jbrd box announces
# that the stream carries exact-JPEG reconstruction data
JPEG_RECONSTRUCTION = "jpeg_reconstruction"

_ALL_EVENTS = (BASIC_INFO, COLOR_ENCODING, FRAME, FULL_IMAGE)


@dataclass
class _FrameState:
    fh: object = None
    fd: object = None
    header_end: int = 0      # bit position after TOC (byte aligned)
    offsets: list = None
    sizes: list = None
    total: int = 0
    state: object = None     # VarDCTState once dc_global decoded
    decoded: set = field(default_factory=set)
    n_sections: int = 0
    done: bool = False


class Decoder:
    """Pull-based suspendable decoder for bare codestreams and containers.

    Incremental granularity: VarDCT still frames and modular frames
    advance per TOC section as bytes arrive; animations advance per
    frame (each kReplace frame decodes and emits FULL_IMAGE as soon as
    its bytes are in, `frame_duration` holds its tick count). Frames
    that blend with or reference earlier frames fall back to
    whole-stream decode via api.codestream, on `device`.
    """

    def __init__(self, events=_ALL_EVENTS, device="cuda"):
        self._events = tuple(events)
        self._device = device
        self.reset()

    # ----------------------------------------------------------- input
    def reset(self):
        self._data = b""
        self._closed = False
        self._emitted = set()
        self._meta = None
        self._codestream_start = None
        self._frame = None
        self._image = None
        self._skip = 0
        self._finished = False
        self._skipped_preview = False
        self._boxes_emitted = 0
        self.box_type = None
        self.box_data = None
        self._preview = None
        self._jbrd_seen = False
        self.frame_duration = None

    def set_input(self, data: bytes):
        """Append bytes (zero-copy semantics of SetInput/ReleaseInput are
        collapsed into an internal buffer: Python owns copies anyway)."""
        if self._closed:
            raise JXLError("input was closed")
        self._data += bytes(data)

    def close_input(self):
        self._closed = True

    def rewind(self):
        """decode.h:393 JxlDecoderRewind: restart from the first frame,
        keeping the input."""
        data, closed = self._data, self._closed
        self.reset()
        self._data, self._closed = data, closed

    def skip_frames(self, n: int):
        """decode.h:409: skip the next n frames (drops their FRAME and
        FULL_IMAGE events)."""
        self._skip += int(n)

    # ------------------------------------------------------- accessors
    @property
    def basic_info(self):
        m = self._meta.m
        return {
            "xsize": self._meta.size.xsize(),
            "ysize": self._meta.size.ysize(),
            "bits_per_sample": m.bit_depth.bits_per_sample,
            "num_extra_channels": len(m.extra_channel_info),
            "have_animation": m.have_animation,
            "xyb_encoded": m.xyb_encoded,
        }

    @property
    def color_encoding(self):
        return self._meta.m.color_encoding

    @property
    def image(self):
        return self._image

    # --------------------------------------------------------- driving
    def process(self):
        """Advance the state machine; returns the next event/status.

        A RuntimeError (a CUDA error, a kernel build or launch failure, a
        missing card) propagates as it is; other internal errors surface
        as JXLError."""
        try:
            return self._process()
        except (JXLError, RuntimeError):
            raise
        except Exception as e:  # internal errors surface as JXLError
            raise JXLError(f"decoder error: {e}") from e

    def _process(self):
        if self._finished:
            return SUCCESS
        if JPEG_RECONSTRUCTION in self._events and not self._jbrd_seen \
                and len(self._data) >= 12 and is_container(self._data):
            try:
                boxes = list(parse_boxes(self._data[12:]))
            except Exception:
                boxes = []
            if any(bt == b"jbrd" for bt, _p, _r in boxes):
                self._jbrd_seen = True
                return JPEG_RECONSTRUCTION
        if BOX in self._events:
            ev = self._next_box_event()
            if ev is not None:
                return ev
        data = self._codestream_bytes()
        if data is None:
            return self._need_more()
        # headers
        if self._meta is None:
            r = BitReader(data)
            try:
                meta = parse_codestream_header(r)
            except JXLError:
                if not self._closed:
                    return self._need_more()
                raise
            if not r.all_reads_within_bounds():
                return self._need_more()
            self._meta = meta
            self._hdr_bits = r.total_bits_consumed()
        if BASIC_INFO in self._events and BASIC_INFO not in self._emitted:
            self._emitted.add(BASIC_INFO)
            return BASIC_INFO
        if COLOR_ENCODING in self._events \
                and COLOR_ENCODING not in self._emitted:
            self._emitted.add(COLOR_ENCODING)
            return COLOR_ENCODING
        if PREVIEW_IMAGE in self._events \
                and PREVIEW_IMAGE not in self._emitted \
                and self._meta.m.have_preview:
            from .codestream import _skip_or_decode_preview

            r = BitReader(data)
            r.skip_bits(self._hdr_bits)
            try:
                self._preview = _skip_or_decode_preview(
                    r, self._meta, want=True)
            except JXLError:
                return self._need_more()
            if not r.all_reads_within_bounds():
                return self._need_more()
            self._emitted.add(PREVIEW_IMAGE)
            return PREVIEW_IMAGE
        return self._process_frame(data)

    def reconstruct_jpeg(self) -> bytes:
        """Exact-JPEG reconstruction from the buffered container
        (JxlDecoderSetJPEGBuffer flow collapsed: valid after the
        JPEG_RECONSTRUCTION event once all input has arrived)."""
        if not self._jbrd_seen:
            raise JXLError("stream has no jbrd reconstruction data")
        from ..jpeg.recompress import reconstruct_jpeg

        return reconstruct_jpeg(self._data)

    @property
    def preview_image(self):
        return self._preview

    def _next_box_event(self):
        """Emit one BOX event per complete container box (decode.h:270
        JXL_DEC_BOX); box_type/box_data expose the current box."""
        if self._data[:2] == CODESTREAM_SIGNATURE:
            return None  # bare codestream: no boxes
        if len(self._data) < 12 or not is_container(self._data):
            return None
        try:
            boxes = list(parse_boxes(self._data[12:]))
        except Exception:
            boxes = []
        if self._boxes_emitted < len(boxes):
            btype, payload, unbounded = boxes[self._boxes_emitted]
            if unbounded and not self._closed:
                # size==0 box extends to EOF: its payload is only
                # complete once the caller closes the input
                return None
            self._boxes_emitted += 1
            self.box_type = btype
            self.box_data = payload
            return BOX
        return None

    def _need_more(self):
        if self._closed:
            raise JXLError("truncated codestream")
        return NEED_MORE_INPUT

    def _codestream_bytes(self):
        """Concatenated codestream payload available so far (container
        jxlc/jxlp assembly or the bare stream)."""
        if self._data[:2] == CODESTREAM_SIGNATURE:
            return self._data
        if len(self._data) < 12:
            return None
        if is_container(self._data):
            parts = []
            try:
                for btype, payload, _ in parse_boxes(self._data[12:]):
                    if btype == b"jxlc":
                        parts.append(payload)
                    elif btype == b"jxlp":
                        parts.append(payload[4:])
            except Exception:
                pass  # incomplete trailing box
            return b"".join(parts) if parts else None
        raise JXLError("not a JPEG XL stream")

    # ------------------------------------------------- frame machinery
    def _process_frame(self, data):
        from ..io.frame_header import FrameHeader
        from ..io.toc import read_group_offsets
        from .frame import num_toc_entries

        fs = self._frame
        if fs is None:
            r = BitReader(data)
            r.skip_bits(self._hdr_bits)
            if self._meta.m.have_preview and not getattr(
                    self, "_skipped_preview", False):
                # skip the preview frame wholesale (its own header + TOC)
                from .codestream import _skip_or_decode_preview

                try:
                    _skip_or_decode_preview(r, self._meta)
                except JXLError:
                    return self._need_more()
                if not r.all_reads_within_bounds():
                    return self._need_more()
                self._hdr_bits = r.total_bits_consumed()
                self._skipped_preview = True
            fh = FrameHeader(self._meta)
            try:
                fh.read(r)
                fd = fh.frame_dimensions()
                n = num_toc_entries(fd, fh.passes.num_passes)
                offsets, sizes, total = read_group_offsets(n, r)
            except JXLError:
                return self._need_more()
            if not r.all_reads_within_bounds():
                return self._need_more()
            r.jump_to_byte_boundary()
            fs = _FrameState(fh=fh, fd=fd,
                             header_end=r.total_bits_consumed() // 8,
                             offsets=offsets, sizes=sizes, total=total,
                             n_sections=n)
            self._frame = fs
            if fh.frame_type not in (FT_DC, FT_REFERENCE_ONLY) \
                    and self._skip == 0 and FRAME in self._events \
                    and ("frame", fs.header_end) not in self._emitted:
                self._emitted.add(("frame", fs.header_end))
                return FRAME
        # simple path: special frames decode whole-stream
        if self._vardct_incremental(fs):
            self._advance_sections(fs, data)
        elif self._modular_incremental(fs):
            self._advance_sections_modular(fs, data)
        elif self._animation_incremental(fs):
            return self._advance_animation(fs, data)
        else:
            return self._decode_whole(data)
        if FRAME_PROGRESSION in self._events \
                and FRAME_PROGRESSION not in self._emitted:
            ndc = fs.fd.num_dc_groups
            if all(1 + g in fs.decoded for g in range(ndc)):
                self._emitted.add(FRAME_PROGRESSION)
                return FRAME_PROGRESSION
        if len(fs.decoded) == fs.n_sections:
            self._finish_frame(fs)
            if self._skip > 0:
                self._skip -= 1
                return self._process()
            if FULL_IMAGE in self._events:
                return FULL_IMAGE
            return SUCCESS
        return self._need_more()

    def _vardct_incremental(self, fs) -> bool:
        from ..io.frame_header import (FLAG_NOISE, FLAG_PATCHES,
                                       FLAG_SPLINES, ENC_VARDCT, FT_REGULAR)

        fh = fs.fh
        return (fh.encoding == ENC_VARDCT and fh.frame_type == FT_REGULAR
                and fh.is_last and fh.passes.num_passes == 1
                and not self._meta.m.have_animation
                and not self._meta.m.extra_channel_info
                and not (fh.flags & (FLAG_NOISE | FLAG_PATCHES
                                     | FLAG_SPLINES))
                and fh.upsampling == 1 and fs.n_sections > 1
                and list(fh.chroma_subsampling.channel_mode) == [0, 0, 0])

    def _animation_incremental(self, fs) -> bool:
        """Per-frame incremental decode of animations: each frame decodes
        and emits FULL_IMAGE as soon as its TOC-declared bytes have
        arrived, instead of waiting for the whole stream (decode.h:
        JXL_DEC_FULL_IMAGE fires once per animation frame). Covers
        independent kReplace frames (encode_animation's output); frames
        that blend or reference earlier frames use the whole-stream
        path."""
        from ..io.frame_header import FLAG_PATCHES, FT_REGULAR

        fh = fs.fh
        return (self._meta.m.have_animation
                and fh.frame_type == FT_REGULAR
                and not self._meta.m.extra_channel_info
                and fh.save_as_reference == 0
                and fh.blending_info.mode == 0
                and not (fh.flags & FLAG_PATCHES))

    def _advance_animation(self, fs, data):
        end = fs.header_end + fs.total
        if len(data) < end:
            return self._need_more()
        from ..io.frame_header import ENC_MODULAR, FrameHeader

        r = BitReader(data)
        r.skip_bits(self._hdr_bits)
        fh = FrameHeader(self._meta)
        fh.read(r)
        skip_this = self._skip > 0
        if skip_this:
            self._skip -= 1
        elif fh.encoding == ENC_MODULAR:
            from .frame import decode_modular_frame

            img = decode_modular_frame(r, fh)
            stacked = np.stack([c.data for c in img.channel], axis=-1)
            bits = self._meta.m.bit_depth.bits_per_sample
            if bits <= 8:
                stacked = stacked.astype(np.uint8)
            elif bits <= 16:
                stacked = stacked.astype(np.uint16)
            self._image = stacked
        else:
            from ..vardct.frame import decode_vardct_frame
            from ..ops.xyb import linear_to_srgb_u8

            # returns linear RGB channels (XYB already undone)
            chans = decode_vardct_frame(r, fh)
            self._image = linear_to_srgb_u8(np.stack(chans, axis=-1))
        self.frame_duration = fh.animation_frame.duration
        # advance the cursor past this frame (sections are byte-aligned)
        self._hdr_bits = end * 8
        self._frame = None
        if fh.is_last:
            self._finished = True
            if not skip_this and FULL_IMAGE in self._events:
                return FULL_IMAGE
            return SUCCESS
        if not skip_this and FULL_IMAGE in self._events:
            return FULL_IMAGE
        return self._process()

    def _modular_incremental(self, fs) -> bool:
        """Per-group incremental decode of modular frames: the section
        layout (dec_frame.cc:568) is format-shared with VarDCT, so each
        TOC-delimited modular stream decodes as soon as its bytes are
        in (decode.h:122-337 round-3 completeness item)."""
        from ..io.frame_header import ENC_MODULAR, FT_REGULAR

        fh = fs.fh
        return (fh.encoding == ENC_MODULAR and fh.frame_type == FT_REGULAR
                and fh.is_last and not self._meta.m.have_animation
                and not (fh.flags & (1 | 2 | 16))
                and fh.upsampling == 1 and fs.n_sections > 1)

    def _advance_sections_modular(self, fs, data):
        """Modular analog of _advance_sections: global tree/channel
        stream, then per-DC-group and per-group modular sections in any
        arrival order (groups are independent streams)."""
        from .frame import (
            ModularFrameState,
            decode_global_info,
            decode_modular_group,
            get_downsampling_bracket,
            modular_ac_stream_id,
            modular_dc_stream_id,
        )

        fd = fs.fd
        fh = fs.fh
        ndc = fd.num_dc_groups
        if fs.state is None:
            sec = self._section_bytes(fs, data, 0)
            if sec is None:
                return
            state = ModularFrameState()
            sr = BitReader(sec)
            if sr.read_bits(1) != 1:
                from ..io.fields import f16_read

                for _ in range(3):
                    f16_read(sr)
            decode_global_info(sr, fh, fd, state)
            fs.state = state
            fs.decoded.add(0)
        state = fs.state
        for g in range(ndc):
            idx = 1 + g
            if idx in fs.decoded:
                continue
            sec = self._section_bytes(fs, data, idx)
            if sec is None:
                continue
            gx = g % fd.xsize_dc_groups
            gy = g // fd.xsize_dc_groups
            rect = (gx * fd.dc_group_dim, gy * fd.dc_group_dim,
                    fd.dc_group_dim, fd.dc_group_dim)
            decode_modular_group(BitReader(sec), fh, fd, state, rect, 3,
                                 1000, modular_dc_stream_id(fd, g))
            fs.decoded.add(idx)
        ac_global_idx = 1 + ndc
        if ac_global_idx not in fs.decoded:
            sec = self._section_bytes(fs, data, ac_global_idx)
            if sec is None:
                return
            fs.decoded.add(ac_global_idx)  # empty for modular frames
        for p in range(fh.passes.num_passes):
            for g in range(fd.num_groups):
                idx = 2 + ndc + p * fd.num_groups + g
                if idx in fs.decoded:
                    continue
                sec = self._section_bytes(fs, data, idx)
                if sec is None:
                    continue
                gx = g % fd.xsize_groups
                gy = g // fd.xsize_groups
                rect = (gx * fd.group_dim, gy * fd.group_dim,
                        fd.group_dim, fd.group_dim)
                min_shift, max_shift = get_downsampling_bracket(
                    fh.passes, p)
                decode_modular_group(BitReader(sec), fh, fd, state, rect,
                                     min_shift, max_shift,
                                     modular_ac_stream_id(fd, g, p))
                fs.decoded.add(idx)

    def _section_bytes(self, fs, data, idx):
        start = fs.header_end + fs.offsets[idx]
        end = start + fs.sizes[idx]
        if end > len(data):
            return None
        return data[start:end]

    def _advance_sections(self, fs, data):
        """Decode every not-yet-decoded section whose bytes are here, in
        dependency order (ProcessSections, dec_frame.cc:568)."""
        from ..vardct import frame as vf

        fd = fs.fd
        ndc = fd.num_dc_groups
        if fs.state is None:
            sec = self._section_bytes(fs, data, 0)
            if sec is None:
                return
            st = vf.VarDCTState(fs.fh, fd)
            sr = BitReader(sec)
            vf.decode_dc_global(sr, st)
            fs.state = st
            fs.decoded.add(0)
        st = fs.state
        for g in range(ndc):
            idx = 1 + g
            if idx in fs.decoded:
                continue
            sec = self._section_bytes(fs, data, idx)
            if sec is None:
                continue
            vf.decode_dc_group(BitReader(sec), st, g)
            fs.decoded.add(idx)
        ac_global_idx = 1 + ndc
        if ac_global_idx not in fs.decoded:
            if not all(1 + g in fs.decoded for g in range(ndc)):
                return
            sec = self._section_bytes(fs, data, ac_global_idx)
            if sec is None:
                return
            vf.decode_ac_global(BitReader(sec), st)
            fs.decoded.add(ac_global_idx)
        for g in range(fd.num_groups):
            idx = 2 + ndc + g
            if idx in fs.decoded:
                continue
            sec = self._section_bytes(fs, data, idx)
            if sec is None:
                continue
            vf.decode_ac_group(BitReader(sec), st, g, 0)
            fs.decoded.add(idx)

    def _render(self, fs):
        from ..ops.xyb import xyb_to_linear_rgb
        from ..render.pipeline import apply_restoration
        from ..vardct import frame as vf

        st = fs.state
        fd = fs.fd
        vf.render_groups(st)
        xyb = st.xyb
        if fs.fh.loop_filter.gab or fs.fh.loop_filter.epf_iters > 0:
            xyb = apply_restoration(xyb, fs.fh, st)
        rgb = xyb_to_linear_rgb(xyb[:, :fd.ysize, :fd.xsize])
        from ..ops.xyb import linear_to_srgb_u8

        return linear_to_srgb_u8(np.stack([rgb[c] for c in range(3)],
                                          axis=-1))

    def _finish_frame(self, fs):
        from ..io.frame_header import ENC_MODULAR

        if fs.fh.encoding == ENC_MODULAR:
            from .frame import finalize_modular_frame

            img = finalize_modular_frame(fs.fh, fs.state)
            chans = [c.data for c in img.channel]
            stacked = np.stack(chans, axis=-1)
            bits = self._meta.m.bit_depth.bits_per_sample
            if bits <= 8:
                stacked = stacked.astype(np.uint8)
            elif bits <= 16:
                stacked = stacked.astype(np.uint16)
            self._image = stacked
        else:
            self._image = self._render(fs)
        self._finished = True
        fs.done = True

    def _decode_whole(self, data):
        """Fallback: decode the entire stream once it is complete."""
        if not self._closed and not self._all_bytes_present(data):
            return NEED_MORE_INPUT
        from .codestream import decode

        img, _meta = decode(data, device=self._device)
        self._image = img if img.ndim == 3 else img[:, :, None]
        self._finished = True
        if self._skip > 0:
            self._skip = 0
        if FULL_IMAGE in self._events:
            return FULL_IMAGE
        return SUCCESS

    def _all_bytes_present(self, data):
        fs = self._frame
        if fs is None:
            return False
        return len(data) >= fs.header_end + fs.total

    # ----------------------------------------------------------- flush
    def flush_image(self):
        """Render the best partial image from the sections decoded so far
        (JxlDecoderFlushImage, decode.h:1449). Returns None before the DC
        global section is in; missing AC groups fall back to their DC."""
        fs = self._frame
        if fs is None or fs.state is None:
            return None
        if self._image is not None:
            return self._image
        import copy

        st = fs.state
        fd = fs.fd
        ndc = fd.num_dc_groups
        if not all(1 + g in fs.decoded for g in range(ndc)):
            return None
        # work on a shallow copy so continued decode stays untouched
        snap = copy.copy(st)
        snap.xyb = np.zeros_like(st.xyb)
        snap.qblocks = dict(st.qblocks)
        # not-yet-decoded groups render from DC alone: zero-AC blocks
        # reconstruct the DC/LLF-only preview the reference flushes for
        # kSkipped sections (dec_frame.h:88)
        from ..vardct import ac_strategy as acs

        for by, bx in np.argwhere(st.is_origin):
            key = (int(by), int(bx))
            if key not in snap.qblocks:
                s_id = int(st.strategy[key[0], key[1]])
                size = acs.COVERED_X[s_id] * acs.COVERED_Y[s_id] * 64
                snap.qblocks[key] = np.zeros((3, size), dtype=np.int64)
        fsnap = _FrameState(fh=fs.fh, fd=fs.fd, state=snap,
                            decoded=fs.decoded, offsets=fs.offsets,
                            sizes=fs.sizes, n_sections=fs.n_sections,
                            header_end=fs.header_end)
        return self._render(fsnap)
