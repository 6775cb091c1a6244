"""Codestream headers: SizeHeader, ImageMetadata and friends.

Field layouts follow the reference bit-for-bit:
- SizeHeader/PreviewHeader/AnimationHeader: lib/jxl/headers.cc:120-194
- BitDepth/ExtraChannelInfo/ImageMetadata/OpsinInverseMatrix/ToneMapping/
  CustomTransformData: lib/jxl/image_metadata.cc
- ColorEncoding/Customxy/CustomTransferFunction:
  lib/jxl/color_encoding_internal.cc:94-213
"""

from __future__ import annotations

from ..base.status import JXLError
from . import upsample_defaults as upd
from .fields import (
    Bits,
    BitsOffset,
    Bundle,
    U32Enc,
    Val,
    bundle_all_default,
    pack_signed,
    unpack_signed,
)

# ----------------------------------------------------------------- enum values
# ColorSpace (cms/color_encoding_cms.h:39-56)
CS_RGB, CS_GRAY, CS_XYB, CS_UNKNOWN = 0, 1, 2, 3
CS_VALID = {CS_RGB, CS_GRAY, CS_XYB, CS_UNKNOWN}
# WhitePoint (:58-64)
WP_D65, WP_CUSTOM, WP_E, WP_DCI = 1, 2, 10, 11
WP_VALID = {WP_D65, WP_CUSTOM, WP_E, WP_DCI}
# Primaries (:67-73)
PR_SRGB, PR_CUSTOM, PR_2100, PR_P3 = 1, 2, 9, 11
PR_VALID = {PR_SRGB, PR_CUSTOM, PR_2100, PR_P3}
# TransferFunction (:76-85)
TF_709, TF_UNKNOWN, TF_LINEAR, TF_SRGB, TF_PQ, TF_DCI, TF_HLG = 1, 2, 8, 13, 16, 17, 18
TF_VALID = {TF_709, TF_UNKNOWN, TF_LINEAR, TF_SRGB, TF_PQ, TF_DCI, TF_HLG}
# RenderingIntent (:87-94)
RI_PERCEPTUAL, RI_RELATIVE, RI_SATURATION, RI_ABSOLUTE = 0, 1, 2, 3
RI_VALID = {RI_PERCEPTUAL, RI_RELATIVE, RI_SATURATION, RI_ABSOLUTE}
# ExtraChannel (image_metadata.h:49-66, values = JXL_CHANNEL_*)
EC_ALPHA, EC_DEPTH, EC_SPOT_COLOR, EC_SELECTION_MASK = 0, 1, 2, 3
EC_BLACK, EC_CFA, EC_THERMAL = 4, 5, 6
EC_UNKNOWN = 15
EC_OPTIONAL = 16
EC_VALID = {EC_ALPHA, EC_DEPTH, EC_SPOT_COLOR, EC_SELECTION_MASK,
            EC_BLACK, EC_CFA, EC_THERMAL, EC_UNKNOWN, EC_OPTIONAL}

# XYB color-space constants (cms/opsin_params.h:20-72)
K_M00, K_M02 = 0.30, 0.078
K_M01 = 1.0 - K_M02 - K_M00
K_M10, K_M12 = 0.23, 0.078
K_M11 = 1.0 - K_M12 - K_M10
K_M20, K_M21 = 0.24342268924547819, 0.20476744424496821
K_M22 = 1.0 - K_M20 - K_M21
OPSIN_ABSORBANCE_MATRIX = [
    [K_M00, K_M01, K_M02],
    [K_M10, K_M11, K_M12],
    [K_M20, K_M21, K_M22],
]
OPSIN_ABSORBANCE_BIAS = 0.0037930732552754493
DEFAULT_INVERSE_OPSIN_MATRIX = [
    [11.031566901960783, -9.866943921568629, -0.16462299647058826],
    [-3.254147380392157, 4.418770392156863, -0.16462299647058826],
    [-3.6588512862745097, 2.7129230470588235, 1.9459282392156863],
]
NEG_OPSIN_BIAS_RGB = [-OPSIN_ABSORBANCE_BIAS] * 3 + [1.0]
# kDefaultQuantBias (quantizer.h:52-57)
DEFAULT_QUANT_BIAS = [
    1.0 - 0.05465007330715401,
    1.0 - 0.07005449891748593,
    1.0 - 0.049935103337343655,
    0.145,
]
DEFAULT_INTENSITY_TARGET = 255.0  # base/common.h:56

_ASPECT_RATIOS = [(1, 1), (12, 10), (4, 3), (3, 2), (16, 9), (5, 4), (2, 1)]

_SIZE_ENC = U32Enc(BitsOffset(9, 1), BitsOffset(13, 1), BitsOffset(18, 1), BitsOffset(30, 1))
_PREVIEW_DIV8_ENC = U32Enc(Val(16), Val(32), BitsOffset(5, 1), BitsOffset(9, 33))
_PREVIEW_ENC = U32Enc(BitsOffset(6, 1), BitsOffset(8, 65), BitsOffset(10, 321), BitsOffset(12, 1345))


def _find_aspect_ratio(xsize: int, ysize: int) -> int:
    for r, (num, den) in enumerate(_ASPECT_RATIOS, start=1):
        if xsize == (ysize * num) // den:
            return r
    return 0


class SizeHeader(Bundle):
    """Image dimensions (headers.cc:120-145)."""

    def visit_fields(self, v):
        v.bool_(self, False, "small")
        if v.conditional(self.small):
            v.bits(self, 5, 0, "ysize_div8_minus_1")
        if v.conditional(not self.small):
            v.u32(self, _SIZE_ENC, 1, "ysize_")
        v.bits(self, 3, 0, "ratio")
        if v.conditional(self.ratio == 0 and self.small):
            v.bits(self, 5, 0, "xsize_div8_minus_1")
        if v.conditional(self.ratio == 0 and not self.small):
            v.u32(self, _SIZE_ENC, 1, "xsize_")

    def ysize(self) -> int:
        return (self.ysize_div8_minus_1 + 1) * 8 if self.small else self.ysize_

    def xsize(self) -> int:
        if self.ratio != 0:
            num, den = _ASPECT_RATIOS[self.ratio - 1]
            return (self.ysize() * num) // den
        return (self.xsize_div8_minus_1 + 1) * 8 if self.small else self.xsize_

    def set(self, xsize: int, ysize: int) -> "SizeHeader":
        if xsize == 0 or ysize == 0 or xsize > 0xFFFFFFFF or ysize > 0xFFFFFFFF:
            raise JXLError("bad image size")
        self.ratio = _find_aspect_ratio(xsize, ysize)
        self.small = ysize <= 256 and ysize % 8 == 0 and (
            self.ratio != 0 or (xsize <= 256 and xsize % 8 == 0)
        )
        if self.small:
            self.ysize_div8_minus_1 = ysize // 8 - 1
        else:
            self.ysize_ = ysize
        if self.ratio == 0:
            if self.small:
                self.xsize_div8_minus_1 = xsize // 8 - 1
            else:
                self.xsize_ = xsize
        assert self.xsize() == xsize and self.ysize() == ysize
        return self


class PreviewHeader(Bundle):
    """Preview dimensions (headers.cc:147-173)."""

    def visit_fields(self, v):
        v.bool_(self, False, "div8")
        if v.conditional(self.div8):
            v.u32(self, _PREVIEW_DIV8_ENC, 1, "ysize_div8")
        if v.conditional(not self.div8):
            v.u32(self, _PREVIEW_ENC, 1, "ysize_")
        v.bits(self, 3, 0, "ratio")
        if v.conditional(self.ratio == 0 and self.div8):
            v.u32(self, _PREVIEW_DIV8_ENC, 1, "xsize_div8")
        if v.conditional(self.ratio == 0 and not self.div8):
            v.u32(self, _PREVIEW_ENC, 1, "xsize_")

    def ysize(self) -> int:
        return self.ysize_div8 * 8 if self.div8 else self.ysize_

    def xsize(self) -> int:
        if self.ratio != 0:
            num, den = _ASPECT_RATIOS[self.ratio - 1]
            return (self.ysize() * num) // den
        return self.xsize_div8 * 8 if self.div8 else self.xsize_


class AnimationHeader(Bundle):
    """Ticks-per-second + loop count (headers.cc:175-189)."""

    def visit_fields(self, v):
        v.u32(self, U32Enc(Val(100), Val(1000), BitsOffset(10, 1), BitsOffset(30, 1)),
              1, "tps_numerator")
        v.u32(self, U32Enc(Val(1), Val(1001), BitsOffset(8, 1), BitsOffset(10, 1)),
              1, "tps_denominator")
        v.u32(self, U32Enc(Val(0), Bits(3), Bits(16), Bits(32)), 0, "num_loops")
        v.bool_(self, False, "have_timecodes")


class BitDepth(Bundle):
    """Sample bit depth (image_metadata.cc:21-61)."""

    def visit_fields(self, v):
        v.bool_(self, False, "floating_point_sample")
        if not self.floating_point_sample:
            v.u32(self, U32Enc(Val(8), Val(10), Val(12), BitsOffset(6, 1)),
                  8, "bits_per_sample")
            self.exponent_bits_per_sample = 0
        else:
            v.u32(self, U32Enc(Val(32), Val(16), Val(24), BitsOffset(6, 1)),
                  32, "bits_per_sample")
            # encoded as exponent-1 in 4 bits
            enc = getattr(self, "exponent_bits_per_sample", 8) - 1
            enc = v.bits_val(enc, 4, 7)
            self.exponent_bits_per_sample = enc + 1
        if self.floating_point_sample:
            if not (2 <= self.exponent_bits_per_sample <= 8):
                raise JXLError("invalid exponent_bits_per_sample")
            mant = self.bits_per_sample - self.exponent_bits_per_sample - 1
            if not (2 <= mant <= 23):
                raise JXLError("invalid bits_per_sample")
        elif self.bits_per_sample > 31:
            raise JXLError("invalid bits_per_sample")


class Customxy(Bundle):
    """Custom chromaticity as zigzagged fixed-point (color_encoding_internal.cc:94-107)."""

    _ENC = U32Enc(Bits(19), BitsOffset(19, 524288), BitsOffset(20, 1048576),
                  BitsOffset(21, 2097152))

    def visit_fields(self, v):
        ux = v.u32_val(pack_signed(getattr(self, "x", 0)), self._ENC, 0)
        self.x = unpack_signed(ux)
        uy = v.u32_val(pack_signed(getattr(self, "y", 0)), self._ENC, 0)
        self.y = unpack_signed(uy)


GAMMA_MUL = 10000000  # kGammaMul: gamma stored as 24-bit int scaled by 1e7
MAX_GAMMA = 8192


class CustomTransferFunction(Bundle):
    """Gamma or enum transfer function (color_encoding_internal.cc:109-136).

    nonserialized_color_space: XYB implies gamma 1/3 and nothing is coded.
    """

    def __init__(self, **kw):
        self.nonserialized_color_space = kw.pop("nonserialized_color_space", CS_RGB)
        super().__init__(**kw)

    def _set_implicit(self) -> bool:
        if self.nonserialized_color_space == CS_XYB:
            self.have_gamma = True
            self.gamma = GAMMA_MUL // 3
            return True
        return False

    def visit_fields(self, v):
        # defaults must exist even when the implicit path is taken
        if not hasattr(self, "have_gamma"):
            self.have_gamma = False
            self.gamma = GAMMA_MUL
            self.transfer_function = TF_SRGB
        if v.conditional(not self._set_implicit()):
            v.bool_(self, False, "have_gamma")
            if v.conditional(self.have_gamma):
                v.bits(self, 24, GAMMA_MUL, "gamma")
                if self.gamma > GAMMA_MUL or self.gamma * MAX_GAMMA < GAMMA_MUL:
                    raise JXLError(f"invalid gamma {self.gamma}")
            if v.conditional(not self.have_gamma):
                v.enum(self, TF_SRGB, "transfer_function")
                if v.is_reading() and self.transfer_function not in TF_VALID:
                    raise JXLError("invalid transfer function")
        if not hasattr(self, "transfer_function"):
            self.transfer_function = TF_SRGB

    def set_default(self):
        self.have_gamma = False
        self.gamma = GAMMA_MUL
        self.transfer_function = TF_SRGB


class ColorEncoding(Bundle):
    """Color encoding bundle (color_encoding_internal.cc:137-213).

    ICC synthesis (CreateICC) is handled by libjxl_tpu.extras.cms; the
    bundle only carries the signaled fields.
    """

    def visit_fields(self, v):
        if v.all_default(self):
            return
        v.bool_(self, False, "want_icc")
        v.enum(self, CS_RGB, "color_space")
        if v.is_reading() and self.color_space not in CS_VALID:
            raise JXLError("invalid color space")
        if v.conditional(not self.want_icc):
            implicit_wp = self.color_space == CS_XYB
            if v.conditional(not implicit_wp):
                v.enum(self, WP_D65, "white_point")
                if v.is_reading() and self.white_point not in WP_VALID:
                    raise JXLError("invalid white point")
                if v.conditional(self.white_point == WP_CUSTOM):
                    self.white = v.visit_nested(self, getattr(self, "white", Customxy()))
            has_primaries = self.color_space not in (CS_GRAY, CS_XYB)
            if v.conditional(has_primaries):
                v.enum(self, PR_SRGB, "primaries")
                if v.is_reading() and self.primaries not in PR_VALID:
                    raise JXLError("invalid primaries")
                if v.conditional(self.primaries == PR_CUSTOM):
                    self.red = v.visit_nested(self, getattr(self, "red", Customxy()))
                    self.green = v.visit_nested(self, getattr(self, "green", Customxy()))
                    self.blue = v.visit_nested(self, getattr(self, "blue", Customxy()))
            self.tf.nonserialized_color_space = self.color_space
            v.visit_nested(self, self.tf)
            v.enum(self, RI_RELATIVE, "rendering_intent")
            if v.is_reading() and self.rendering_intent not in RI_VALID:
                raise JXLError("invalid rendering intent")

    def set_default(self):
        self.all_default = True
        self.want_icc = False
        self.color_space = CS_RGB
        self.white_point = WP_D65
        self.primaries = PR_SRGB
        self.tf = CustomTransferFunction()
        self.rendering_intent = RI_RELATIVE
        self.icc = b""

    def is_gray(self) -> bool:
        return self.color_space == CS_GRAY

    @classmethod
    def srgb(cls, is_gray: bool = False) -> "ColorEncoding":
        ce = cls()
        ce.color_space = CS_GRAY if is_gray else CS_RGB
        return ce

    @classmethod
    def linear_srgb(cls, is_gray: bool = False) -> "ColorEncoding":
        ce = cls.srgb(is_gray)
        ce.tf.transfer_function = TF_LINEAR
        return ce


class ExtraChannelInfo(Bundle):
    """Per-extra-channel metadata (image_metadata.cc:216-262)."""

    def visit_fields(self, v):
        if v.all_default(self):
            return
        v.enum(self, EC_ALPHA, "type")
        v.visit_nested(self, self.bit_depth)
        v.u32(self, U32Enc(Val(0), Val(3), Val(4), BitsOffset(3, 1)), 0, "dim_shift")
        if (1 << self.dim_shift) > 8:
            raise JXLError("dim_shift too large")
        v.name_string(self, "name")
        if v.conditional(self.type == EC_ALPHA):
            v.bool_(self, False, "alpha_associated")
        if v.conditional(self.type == EC_SPOT_COLOR):
            self.spot_color = [
                v.f16_val(c, 0.0)
                for c in (getattr(self, "spot_color", None) or [0.0] * 4)
            ]
        if v.conditional(self.type == EC_CFA):
            v.u32(self, U32Enc(Val(1), Bits(2), BitsOffset(4, 3), BitsOffset(8, 19)),
                  1, "cfa_channel")
        if self.type not in EC_VALID:
            raise JXLError("unknown extra channel type")

    def set_default(self):
        self.all_default = True
        self.type = EC_ALPHA
        self.bit_depth = BitDepth()
        self.dim_shift = 0
        self.name = ""
        self.alpha_associated = False
        self.spot_color = [0.0] * 4
        self.cfa_channel = 1


class OpsinInverseMatrix(Bundle):
    """Signaled XYB inverse matrix + biases (image_metadata.cc:354-378)."""

    def visit_fields(self, v):
        if v.all_default(self):
            return
        for j in range(3):
            for i in range(3):
                self.inverse_matrix[j][i] = v.f16_val(
                    self.inverse_matrix[j][i], DEFAULT_INVERSE_OPSIN_MATRIX[j][i]
                )
        for i in range(3):
            self.opsin_biases[i] = v.f16_val(self.opsin_biases[i], NEG_OPSIN_BIAS_RGB[i])
        for i in range(4):
            self.quant_biases[i] = v.f16_val(self.quant_biases[i], DEFAULT_QUANT_BIAS[i])

    def set_default(self):
        self.all_default = True
        self.inverse_matrix = [row[:] for row in DEFAULT_INVERSE_OPSIN_MATRIX]
        self.opsin_biases = NEG_OPSIN_BIAS_RGB[:3]
        self.quant_biases = DEFAULT_QUANT_BIAS[:]


class ToneMapping(Bundle):
    """HDR tone-mapping hints (image_metadata.cc:380-409)."""

    def visit_fields(self, v):
        if v.all_default(self):
            return
        v.f16(self, DEFAULT_INTENSITY_TARGET, "intensity_target")
        if self.intensity_target <= 0:
            raise JXLError("invalid intensity target")
        v.f16(self, 0.0, "min_nits")
        if self.min_nits < 0 or self.min_nits > self.intensity_target:
            raise JXLError("invalid min_nits")
        v.bool_(self, False, "relative_to_max_display")
        v.f16(self, 0.0, "linear_below")
        if self.linear_below < 0 or (self.relative_to_max_display and self.linear_below > 1.0):
            raise JXLError("invalid linear_below")


class CustomTransformData(Bundle):
    """Opsin inverse + custom upsampling kernels (image_metadata.cc:73-210)."""

    def __init__(self, **kw):
        self.nonserialized_xyb_encoded = kw.pop("nonserialized_xyb_encoded", True)
        super().__init__(**kw)

    def visit_fields(self, v):
        if v.all_default(self):
            return
        if v.conditional(self.nonserialized_xyb_encoded):
            v.visit_nested(self, self.opsin_inverse_matrix)
        v.bits(self, 3, 0, "custom_weights_mask")
        if v.conditional(self.custom_weights_mask & 1):
            for i in range(15):
                self.upsampling2_weights[i] = v.f16_val(
                    self.upsampling2_weights[i], upd.UPSAMPLE2_WEIGHTS[i])
        if v.conditional(self.custom_weights_mask & 2):
            for i in range(55):
                self.upsampling4_weights[i] = v.f16_val(
                    self.upsampling4_weights[i], upd.UPSAMPLE4_WEIGHTS[i])
        if v.conditional(self.custom_weights_mask & 4):
            for i in range(210):
                self.upsampling8_weights[i] = v.f16_val(
                    self.upsampling8_weights[i], upd.UPSAMPLE8_WEIGHTS[i])

    def set_default(self):
        self.all_default = True
        self.opsin_inverse_matrix = OpsinInverseMatrix()
        self.custom_weights_mask = 0
        self.upsampling2_weights = list(upd.UPSAMPLE2_WEIGHTS)
        self.upsampling4_weights = list(upd.UPSAMPLE4_WEIGHTS)
        self.upsampling8_weights = list(upd.UPSAMPLE8_WEIGHTS)


class ImageMetadata(Bundle):
    """Top-level image metadata (image_metadata.cc:278-352)."""

    def visit_fields(self, v):
        if v.all_default(self):
            return
        if v.is_reading():
            extra_fields = v.bool_val(False, False)
        else:
            tm_default = bundle_all_default(self.tone_mapping)
            extra_fields = (self.orientation != 1 or self.have_preview
                            or self.have_animation or self.have_intrinsic_size
                            or not tm_default)
            v.bool_val(extra_fields, False)
        self._extra_fields = extra_fields
        if v.conditional(extra_fields):
            self.orientation = v.bits_val(self.orientation - 1, 3, 0) + 1
            v.bool_(self, False, "have_intrinsic_size")
            if v.conditional(self.have_intrinsic_size):
                v.visit_nested(self, self.intrinsic_size)
            v.bool_(self, False, "have_preview")
            if v.conditional(self.have_preview):
                v.visit_nested(self, self.preview_size)
            v.bool_(self, False, "have_animation")
            if v.conditional(self.have_animation):
                v.visit_nested(self, self.animation)
        else:
            self.orientation = 1
            self.have_intrinsic_size = False
            self.have_preview = False
            self.have_animation = False
        v.visit_nested(self, self.bit_depth)
        v.bool_(self, True, "modular_16_bit_buffer_sufficient")
        self.num_extra_channels = len(self.extra_channel_info) if not v.is_reading() else 0
        v.u32(self, U32Enc(Val(0), Val(1), BitsOffset(4, 2), BitsOffset(12, 1)),
              0, "num_extra_channels")
        if v.conditional(self.num_extra_channels != 0):
            if v.is_reading():
                self.extra_channel_info = [ExtraChannelInfo() for _ in range(self.num_extra_channels)]
            for eci in self.extra_channel_info:
                v.visit_nested(self, eci)
        v.bool_(self, True, "xyb_encoded")
        v.visit_nested(self, self.color_encoding)
        if v.conditional(self._extra_fields):
            v.visit_nested(self, self.tone_mapping)
        v.begin_extensions(self)
        v.end_extensions()

    def set_default(self):
        self.all_default = True
        self.orientation = 1
        self.have_intrinsic_size = False
        self.intrinsic_size = SizeHeader()
        self.have_preview = False
        self.preview_size = PreviewHeader()
        self.have_animation = False
        self.animation = AnimationHeader()
        self.bit_depth = BitDepth()
        self.modular_16_bit_buffer_sufficient = True
        self.num_extra_channels = 0
        self.extra_channel_info = []
        self.xyb_encoded = True
        self.color_encoding = ColorEncoding()
        self.tone_mapping = ToneMapping()
        self.extensions = 0
        self._extra_fields = False

class CodecMetadata:
    """SizeHeader + ImageMetadata + CustomTransformData (metadata aggregate,
    reference image_metadata.h:350-380)."""

    def __init__(self):
        self.size = SizeHeader().set(1, 1)
        self.m = ImageMetadata()
        self.transform_data = CustomTransformData()

    def xsize(self) -> int:
        return self.size.xsize()

    def ysize(self) -> int:
        return self.size.ysize()
