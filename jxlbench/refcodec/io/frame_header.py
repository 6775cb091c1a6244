"""FrameHeader and nested bundles.

Bit layouts follow the reference exactly:
- BlendingInfo/AnimationFrame/Passes/FrameHeader: lib/jxl/frame_header.cc
- LoopFilter: lib/jxl/loop_filter.cc:16-99
- FrameDimensions: lib/jxl/frame_dimensions.h:33-61
"""

from __future__ import annotations

from dataclasses import dataclass

from ..base.status import JXLError
from .fields import Bits, BitsOffset, Bundle, U32Enc, Val, pack_signed, unpack_signed
from .headers import CodecMetadata

# Frame constants (base/common.h, frame_dimensions.h)
BLOCK_DIM = 8
DCT_BLOCK_SIZE = 64
GROUP_DIM = 256
GROUP_DIM_IN_BLOCKS = GROUP_DIM // BLOCK_DIM
MAX_NUM_PASSES = 11
MAX_NUM_REFERENCE_FRAMES = 4

# FrameType (frame_header.h:311-325)
FT_REGULAR, FT_DC, FT_REFERENCE_ONLY, FT_SKIP_PROGRESSIVE = 0, 1, 2, 3
# FrameEncoding
ENC_VARDCT, ENC_MODULAR = 0, 1
# ColorTransform
CT_XYB, CT_NONE, CT_YCBCR = 0, 1, 2
# BlendMode (frame_header.h:181-209)
BLEND_REPLACE, BLEND_ADD, BLEND_BLEND, BLEND_ALPHA_WEIGHTED_ADD, BLEND_MUL = range(5)
# Frame flags (frame_header.h:338-354)
FLAG_NOISE = 1
FLAG_PATCHES = 2
FLAG_SPLINES = 16
FLAG_USE_DC_FRAME = 32
FLAG_SKIP_ADAPTIVE_DC_SMOOTHING = 128

EPF_SHARP_ENTRIES = 8

# Gaborish default weights (loop_filter.cc:30-48)
GAB_W1_DEFAULT = 1.1 * 0.104699568
GAB_W2_DEFAULT = 1.1 * 0.055680538


def div_ceil(a: int, b: int) -> int:
    return -(-a // b)


class BlendingInfo(Bundle):
    """Blend mode + alpha channel + source slot (frame_header.cc:56-84)."""

    def __init__(self, **kw):
        self.nonserialized_num_extra_channels = kw.pop("num_extra_channels", 0)
        self.nonserialized_is_partial_frame = kw.pop("is_partial_frame", False)
        super().__init__(**kw)

    def visit_fields(self, v):
        v.u32(self, U32Enc(Val(BLEND_REPLACE), Val(BLEND_ADD), Val(BLEND_BLEND),
                           BitsOffset(2, 3)), BLEND_REPLACE, "mode")
        if self.mode > BLEND_MUL:
            raise JXLError("invalid blend mode")
        nec = self.nonserialized_num_extra_channels
        has_alpha_blend = nec > 0 and self.mode in (BLEND_BLEND, BLEND_ALPHA_WEIGHTED_ADD)
        if v.conditional(has_alpha_blend):
            v.u32(self, U32Enc(Val(0), Val(1), Val(2), BitsOffset(3, 3)),
                  0, "alpha_channel")
            if v.is_reading() and self.alpha_channel >= nec:
                raise JXLError("invalid alpha channel for blending")
        if v.conditional(has_alpha_blend or self.mode == BLEND_MUL):
            v.bool_(self, False, "clamp")
        if v.conditional(self.mode != BLEND_REPLACE or self.nonserialized_is_partial_frame):
            v.u32(self, U32Enc(Val(0), Val(1), Val(2), Val(3)), 0, "source")


class AnimationFrame(Bundle):
    """Duration/timecode, coded only when animation is on (frame_header.cc:111-126)."""

    def __init__(self, metadata: CodecMetadata = None, **kw):
        self.nonserialized_metadata = metadata
        super().__init__(**kw)

    def visit_fields(self, v):
        m = self.nonserialized_metadata
        if v.conditional(m is not None and m.m.have_animation):
            v.u32(self, U32Enc(Val(0), Val(1), Bits(8), Bits(32)), 0, "duration")
        if v.conditional(m is not None and m.m.have_animation
                         and m.m.animation.have_timecodes):
            v.bits(self, 32, 0, "timecode")


class YCbCrChromaSubsampling(Bundle):
    """Per-channel 4:2:0/4:2:2 modes (frame_header.h:81-131).

    channel_mode order is (Cb, Y, Cr) as in the codestream; shift tables
    kHShift={0,1,1,0}, kVShift={0,1,0,1} (frame_header.cc:21-22).
    """

    K_HSHIFT = (0, 1, 1, 0)
    K_VSHIFT = (0, 1, 0, 1)

    def visit_fields(self, v):
        cm = getattr(self, "channel_mode", None) or [0, 0, 0]
        self.channel_mode = [v.bits_val(cm[i], 2, 0) for i in range(3)]

    def set_default(self):
        self.channel_mode = [0, 0, 0]

    def max_hshift(self) -> int:
        return max(self.K_HSHIFT[m] for m in self.channel_mode)

    def max_vshift(self) -> int:
        return max(self.K_VSHIFT[m] for m in self.channel_mode)

    def hshift(self, c: int) -> int:
        return self.max_hshift() - self.K_HSHIFT[self.channel_mode[c]]

    def vshift(self, c: int) -> int:
        return self.max_vshift() - self.K_VSHIFT[self.channel_mode[c]]

    def is_444(self) -> bool:
        return all(self.hshift(c) == 0 and self.vshift(c) == 0 for c in range(3))


class Passes(Bundle):
    """Progressive pass structure (frame_header.cc:128-167)."""

    def visit_fields(self, v):
        v.u32(self, U32Enc(Val(1), Val(2), Val(3), BitsOffset(3, 4)), 1, "num_passes")
        if self.num_passes > MAX_NUM_PASSES:
            raise JXLError("too many passes")
        if v.conditional(self.num_passes != 1):
            v.u32(self, U32Enc(Val(0), Val(1), Val(2), BitsOffset(1, 3)),
                  0, "num_downsample")
            if self.num_downsample > self.num_passes:
                raise JXLError("num_downsample > num_passes")
            for i in range(self.num_passes - 1):
                self.shift[i] = v.bits_val(self.shift[i], 2, 0)
            self.shift[self.num_passes - 1] = 0
            ds_enc = U32Enc(Val(1), Val(2), Val(4), Val(8))
            for i in range(self.num_downsample):
                self.downsample[i] = v.u32_val(self.downsample[i], ds_enc, 1)
                if i > 0 and self.downsample[i] >= self.downsample[i - 1]:
                    raise JXLError("downsample sequence should be decreasing")
            lp_enc = U32Enc(Val(0), Val(1), Val(2), Bits(3))
            for i in range(self.num_downsample):
                self.last_pass[i] = v.u32_val(self.last_pass[i], lp_enc, 0)
                if i > 0 and self.last_pass[i] <= self.last_pass[i - 1]:
                    raise JXLError("last_pass sequence should be increasing")
                if self.last_pass[i] >= self.num_passes:
                    raise JXLError("last_pass >= num_passes")

    def set_default(self):
        self.num_passes = 1
        self.num_downsample = 0
        self.shift = [0] * MAX_NUM_PASSES
        self.downsample = [1] * MAX_NUM_PASSES
        self.last_pass = [0] * MAX_NUM_PASSES


class LoopFilter(Bundle):
    """Gaborish + EPF restoration filter config (loop_filter.cc:16-99)."""

    def __init__(self, **kw):
        self.nonserialized_is_modular = kw.pop("is_modular", False)
        super().__init__(**kw)

    def visit_fields(self, v):
        if v.all_default(self):
            return
        v.bool_(self, True, "gab")
        if v.conditional(self.gab):
            v.bool_(self, False, "gab_custom")
            if v.conditional(self.gab_custom):
                for ch in ("x", "y", "b"):
                    w1 = v.f16_val(getattr(self, f"gab_{ch}_weight1"), GAB_W1_DEFAULT)
                    w2 = v.f16_val(getattr(self, f"gab_{ch}_weight2"), GAB_W2_DEFAULT)
                    setattr(self, f"gab_{ch}_weight1", w1)
                    setattr(self, f"gab_{ch}_weight2", w2)
                    if abs(1.0 + (w1 + w2) * 4) < 1e-8:
                        raise JXLError("Gaborish weights lead to near-0 kernel")
        v.bits(self, 2, 2, "epf_iters")
        if v.conditional(self.epf_iters > 0):
            if v.conditional(not self.nonserialized_is_modular):
                v.bool_(self, False, "epf_sharp_custom")
                if v.conditional(self.epf_sharp_custom):
                    for i in range(EPF_SHARP_ENTRIES):
                        self.epf_sharp_lut[i] = v.f16_val(
                            self.epf_sharp_lut[i], i / (EPF_SHARP_ENTRIES - 1))
            v.bool_(self, False, "epf_weight_custom")
            if v.conditional(self.epf_weight_custom):
                for i, d in enumerate((40.0, 5.0, 3.5)):
                    self.epf_channel_scale[i] = v.f16_val(self.epf_channel_scale[i], d)
                v.f16(self, 0.45, "epf_pass1_zeroflush")
                v.f16(self, 0.6, "epf_pass2_zeroflush")
            v.bool_(self, False, "epf_sigma_custom")
            if v.conditional(self.epf_sigma_custom):
                if v.conditional(not self.nonserialized_is_modular):
                    v.f16(self, 0.46, "epf_quant_mul")
                v.f16(self, 0.9, "epf_pass0_sigma_scale")
                v.f16(self, 6.5, "epf_pass2_sigma_scale")
                v.f16(self, 0.6666666666666666, "epf_border_sad_mul")
            if v.conditional(self.nonserialized_is_modular):
                v.f16(self, 1.0, "epf_sigma_for_modular")
                if self.epf_sigma_for_modular < 1e-8:
                    raise JXLError("EPF sigma for modular too small")
        v.begin_extensions(self)
        v.end_extensions()

    def set_default(self):
        self.all_default = True
        self.gab = True
        self.gab_custom = False
        for ch in ("x", "y", "b"):
            setattr(self, f"gab_{ch}_weight1", GAB_W1_DEFAULT)
            setattr(self, f"gab_{ch}_weight2", GAB_W2_DEFAULT)
        self.epf_iters = 2
        self.epf_sharp_custom = False
        self.epf_sharp_lut = [i / (EPF_SHARP_ENTRIES - 1) for i in range(EPF_SHARP_ENTRIES)]
        self.epf_weight_custom = False
        self.epf_channel_scale = [40.0, 5.0, 3.5]
        self.epf_pass1_zeroflush = 0.45
        self.epf_pass2_zeroflush = 0.6
        self.epf_sigma_custom = False
        self.epf_quant_mul = 0.46
        self.epf_pass0_sigma_scale = 0.9
        self.epf_pass2_sigma_scale = 6.5
        self.epf_border_sad_mul = 0.6666666666666666
        self.epf_sigma_for_modular = 1.0
        self.extensions = 0


_CROP_ENC = U32Enc(Bits(8), BitsOffset(11, 256), BitsOffset(14, 2304), BitsOffset(30, 18688))


class FrameHeader(Bundle):
    """Per-frame header (frame_header.cc:206-427)."""

    def __init__(self, metadata: CodecMetadata = None, **kw):
        self.nonserialized_metadata = metadata
        self.nonserialized_is_preview = kw.pop("is_preview", False)
        super().__init__(**kw)

    def visit_fields(self, v):
        if v.all_default(self):
            return
        v.u32(self, U32Enc(Val(FT_REGULAR), Val(FT_DC), Val(FT_REFERENCE_ONLY),
                           Val(FT_SKIP_PROGRESSIVE)), FT_REGULAR, "frame_type")
        is_modular = v.bool_val(self.encoding == ENC_MODULAR, False)
        self.encoding = ENC_MODULAR if is_modular else ENC_VARDCT
        v.u64(self, 0, "flags")
        m = self.nonserialized_metadata
        xyb_encoded = m is None or m.m.xyb_encoded
        if xyb_encoded:
            self.color_transform = CT_XYB
        else:
            alternate = v.bool_val(self.color_transform == CT_YCBCR, False)
            self.color_transform = CT_YCBCR if alternate else CT_NONE
        if v.conditional(self.color_transform == CT_YCBCR
                         and (self.flags & FLAG_USE_DC_FRAME) == 0):
            v.visit_nested(self, self.chroma_subsampling)
        num_extra = len(m.m.extra_channel_info) if m is not None else 0
        if v.conditional((self.flags & FLAG_USE_DC_FRAME) == 0):
            v.u32(self, U32Enc(Val(1), Val(2), Val(4), Val(8)), 1, "upsampling")
            if m is not None and v.conditional(num_extra != 0):
                up_enc = U32Enc(Val(1), Val(2), Val(4), Val(8))
                self.extra_channel_upsampling = (
                    self.extra_channel_upsampling or [1] * num_extra)
                for i in range(num_extra):
                    dim_shift = m.m.extra_channel_info[i].dim_shift
                    ec_up = self.extra_channel_upsampling[i] >> dim_shift
                    ec_up = v.u32_val(ec_up, up_enc, 1)
                    ec_up <<= dim_shift
                    self.extra_channel_upsampling[i] = ec_up
                    if ec_up < self.upsampling or ec_up > 8:
                        raise JXLError("invalid extra channel upsampling")
            else:
                self.extra_channel_upsampling = []
        if v.conditional(self.encoding == ENC_MODULAR):
            v.bits(self, 2, 1, "group_size_shift")
        if v.conditional(self.encoding == ENC_VARDCT and self.color_transform == CT_XYB):
            v.bits(self, 3, 3, "x_qm_scale")
            v.bits(self, 3, 2, "b_qm_scale")
        else:
            self.x_qm_scale = self.b_qm_scale = 2
        if v.conditional(self.frame_type != FT_REFERENCE_ONLY):
            v.visit_nested(self, self.passes)
        if v.conditional(self.frame_type == FT_DC):
            v.u32(self, U32Enc(Val(1), Val(2), Val(3), Val(4)), 1, "dc_level")
        if self.frame_type != FT_DC:
            self.dc_level = 0
        is_partial_frame = False
        if v.conditional(self.frame_type != FT_DC):
            v.bool_(self, False, "custom_size_or_origin")
            if v.conditional(self.custom_size_or_origin):
                if v.conditional(self.frame_type in (FT_REGULAR, FT_SKIP_PROGRESSIVE)):
                    ux0 = v.u32_val(pack_signed(self.x0), _CROP_ENC, 0)
                    uy0 = v.u32_val(pack_signed(self.y0), _CROP_ENC, 0)
                    self.x0, self.y0 = unpack_signed(ux0), unpack_signed(uy0)
                v.u32(self, _CROP_ENC, 0, "frame_xsize")
                v.u32(self, _CROP_ENC, 0, "frame_ysize")
                if self.custom_size_or_origin and (self.frame_xsize == 0 or self.frame_ysize == 0):
                    raise JXLError("invalid crop dimensions")
                if self.frame_type in (FT_REGULAR, FT_SKIP_PROGRESSIVE) and m is not None:
                    is_partial_frame = (
                        self.x0 > 0 or self.y0 > 0
                        or self.frame_xsize + self.x0 < m.xsize()
                        or self.frame_ysize + self.y0 < m.ysize())
        if v.conditional(self.frame_type in (FT_REGULAR, FT_SKIP_PROGRESSIVE)):
            self.blending_info.nonserialized_num_extra_channels = num_extra
            self.blending_info.nonserialized_is_partial_frame = is_partial_frame
            v.visit_nested(self, self.blending_info)
            if len(self.extra_channel_blending_info) != num_extra:
                self.extra_channel_blending_info = [
                    BlendingInfo() for _ in range(num_extra)]
            for bi in self.extra_channel_blending_info:
                bi.nonserialized_num_extra_channels = num_extra
                bi.nonserialized_is_partial_frame = is_partial_frame
                v.visit_nested(self, bi)
            if v.conditional(m is not None and m.m.have_animation):
                self.animation_frame.nonserialized_metadata = m
                v.visit_nested(self, self.animation_frame)
            v.bool_(self, True, "is_last")
        else:
            self.is_last = False
        if v.conditional(self.frame_type != FT_DC and not self.is_last):
            v.u32(self, U32Enc(Val(0), Val(1), Val(2), Val(3)), 0, "save_as_reference")
        if self.frame_type != FT_DC:
            # CanBeReferenced (frame_header.h:373-379): a zero-duration
            # non-last frame can ALWAYS be referenced (the duration==0
            # alternative matters: preview and zero-duration frames
            # carry the save_before_color_transform bool even with
            # save_as_reference == 0)
            can_reference = (not self.is_last
                             and (self.animation_frame.duration == 0
                                  or self.save_as_reference != 0))
            if v.conditional(can_reference
                             and self.blending_info.mode == BLEND_REPLACE
                             and not is_partial_frame
                             and self.frame_type in (FT_REGULAR, FT_SKIP_PROGRESSIVE)):
                v.bool_(self, False, "save_before_color_transform")
            elif v.conditional(self.frame_type == FT_REFERENCE_ONLY):
                self.save_before_color_transform = v.bool_val(
                    self.save_before_color_transform, True)
        else:
            self.save_before_color_transform = True
        v.name_string(self, "name")
        self.loop_filter.nonserialized_is_modular = is_modular
        v.visit_nested(self, self.loop_filter)
        v.begin_extensions(self)
        v.end_extensions()

    def set_default(self):
        self.all_default = True
        self.frame_type = FT_REGULAR
        self.encoding = ENC_VARDCT
        self.flags = 0
        self.color_transform = CT_XYB
        self.chroma_subsampling = YCbCrChromaSubsampling()
        self.upsampling = 1
        self.extra_channel_upsampling = []
        self.group_size_shift = 1
        self.x_qm_scale = 3
        self.b_qm_scale = 2
        self.passes = Passes()
        self.dc_level = 0
        self.custom_size_or_origin = False
        self.x0 = 0
        self.y0 = 0
        self.frame_xsize = 0
        self.frame_ysize = 0
        self.blending_info = BlendingInfo()
        self.extra_channel_blending_info = []
        self.animation_frame = AnimationFrame(getattr(self, "nonserialized_metadata", None))
        self.is_last = True
        self.save_as_reference = 0
        self.save_before_color_transform = False
        self.name = ""
        self.loop_filter = LoopFilter()
        self.extensions = 0

    # ---- derived
    def is_lossy(self) -> bool:
        return self.encoding == ENC_VARDCT

    def needs_color_transform(self) -> bool:
        return self.color_transform == CT_XYB

    def xsize(self) -> int:
        if getattr(self, "nonserialized_is_preview", False):
            return self.nonserialized_metadata.m.preview_size.xsize()
        if self.custom_size_or_origin:
            base = self.frame_xsize
        else:
            base = self.nonserialized_metadata.xsize()
        if self.frame_type == FT_DC:
            # a kDCFrame covers the next frame at 1:8^dc_level
            base = -(-base // (1 << (3 * self.dc_level)))
        return base

    def ysize(self) -> int:
        if getattr(self, "nonserialized_is_preview", False):
            return self.nonserialized_metadata.m.preview_size.ysize()
        if self.custom_size_or_origin:
            base = self.frame_ysize
        else:
            base = self.nonserialized_metadata.ysize()
        if self.frame_type == FT_DC:
            base = -(-base // (1 << (3 * self.dc_level)))
        return base

    def frame_dimensions(self) -> "FrameDimensions":
        fd = FrameDimensions()
        maxhs = self.chroma_subsampling.max_hshift() if self.color_transform == CT_YCBCR else 0
        maxvs = self.chroma_subsampling.max_vshift() if self.color_transform == CT_YCBCR else 0
        fd.set(self.xsize(), self.ysize(), self.group_size_shift, maxhs, maxvs,
               self.encoding == ENC_MODULAR, self.upsampling)
        return fd


@dataclass
class FrameDimensions:
    """Derived frame geometry (frame_dimensions.h:33-61)."""

    xsize: int = 0
    ysize: int = 0
    xsize_upsampled: int = 0
    ysize_upsampled: int = 0
    xsize_upsampled_padded: int = 0
    ysize_upsampled_padded: int = 0
    xsize_padded: int = 0
    ysize_padded: int = 0
    xsize_blocks: int = 0
    ysize_blocks: int = 0
    xsize_groups: int = 0
    ysize_groups: int = 0
    xsize_dc_groups: int = 0
    ysize_dc_groups: int = 0
    num_groups: int = 0
    num_dc_groups: int = 0
    group_dim: int = GROUP_DIM
    dc_group_dim: int = GROUP_DIM * BLOCK_DIM

    def set(self, xsize, ysize, group_size_shift=1, max_hshift=0, max_vshift=0,
            modular_mode=False, upsampling=1):
        self.group_dim = (GROUP_DIM >> 1) << group_size_shift
        self.dc_group_dim = self.group_dim * BLOCK_DIM
        self.xsize_upsampled = xsize
        self.ysize_upsampled = ysize
        self.xsize = div_ceil(xsize, upsampling)
        self.ysize = div_ceil(ysize, upsampling)
        self.xsize_blocks = div_ceil(self.xsize, BLOCK_DIM << max_hshift) << max_hshift
        self.ysize_blocks = div_ceil(self.ysize, BLOCK_DIM << max_vshift) << max_vshift
        self.xsize_padded = self.xsize_blocks * BLOCK_DIM
        self.ysize_padded = self.ysize_blocks * BLOCK_DIM
        if modular_mode:
            self.xsize_padded = self.xsize
            self.ysize_padded = self.ysize
        self.xsize_upsampled_padded = self.xsize_padded * upsampling
        self.ysize_upsampled_padded = self.ysize_padded * upsampling
        self.xsize_groups = div_ceil(self.xsize, self.group_dim)
        self.ysize_groups = div_ceil(self.ysize, self.group_dim)
        self.xsize_dc_groups = div_ceil(self.xsize_blocks, self.group_dim)
        self.ysize_dc_groups = div_ceil(self.ysize_blocks, self.group_dim)
        self.num_groups = self.xsize_groups * self.ysize_groups
        self.num_dc_groups = self.xsize_dc_groups * self.ysize_dc_groups
        return self

    def dc_group_rect(self, group_index: int):
        """(x0, y0, xsize, ysize) in blocks of a DC group."""
        gx = group_index % self.xsize_dc_groups
        gy = group_index // self.xsize_dc_groups
        x0, y0 = gx * self.group_dim, gy * self.group_dim
        return (x0, y0, min(self.group_dim, self.xsize_blocks - x0),
                min(self.group_dim, self.ysize_blocks - y0))
