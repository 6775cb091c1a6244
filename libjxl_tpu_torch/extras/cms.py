"""Color management via the system lcms2 (the reference's CMS backend).

Mirrors the role of lib/jxl/cms/jxl_cms.cc (skcms + lcms2) for this
framework: arbitrary ICC input profiles are converted to linear sRGB
before XYB encoding, and decoded pixels can be converted back out to a
target ICC profile (render_pipeline/stage_cms.cc analog). Falls back
gracefully when liblcms2 is not installed (``available()`` -> False);
callers then pass pixels through untouched, as round 1 did.

ctypes over the stable lcms2 ABI — no headers needed.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from ctypes import POINTER, c_char_p, c_double, c_uint32, c_void_p

import numpy as np

# lcms2 pixel formats (lcms2.h macro expansions)
#   FLOAT_SH(1)|COLORSPACE_SH(PT_RGB=4)|CHANNELS_SH(3)|BYTES_SH(4)
TYPE_RGB_FLT = (1 << 22) | (4 << 16) | (3 << 3) | 4
TYPE_RGB_8 = (4 << 16) | (3 << 3) | 1
TYPE_GRAY_FLT = (1 << 22) | (3 << 16) | (1 << 3) | 4

INTENT_PERCEPTUAL = 0
INTENT_RELATIVE_COLORIMETRIC = 1


class _CIExyY(ctypes.Structure):
    _fields_ = [("x", c_double), ("y", c_double), ("Y", c_double)]


class _CIExyYTRIPLE(ctypes.Structure):
    _fields_ = [("Red", _CIExyY), ("Green", _CIExyY), ("Blue", _CIExyY)]


_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    for name in ("liblcms2.so.2", "liblcms2.so", "lcms2",
                 ctypes.util.find_library("lcms2")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        return None
    lib.cmsOpenProfileFromMem.restype = c_void_p
    lib.cmsOpenProfileFromMem.argtypes = [c_char_p, c_uint32]
    lib.cmsCreate_sRGBProfile.restype = c_void_p
    lib.cmsCreateRGBProfile.restype = c_void_p
    lib.cmsCreateRGBProfile.argtypes = [
        POINTER(_CIExyY), POINTER(_CIExyYTRIPLE), POINTER(c_void_p)]
    lib.cmsBuildGamma.restype = c_void_p
    lib.cmsBuildGamma.argtypes = [c_void_p, c_double]
    lib.cmsFreeToneCurve.argtypes = [c_void_p]
    lib.cmsCreateTransform.restype = c_void_p
    lib.cmsCreateTransform.argtypes = [
        c_void_p, c_uint32, c_void_p, c_uint32, c_uint32, c_uint32]
    lib.cmsDoTransform.argtypes = [c_void_p, c_void_p, c_void_p, c_uint32]
    lib.cmsDeleteTransform.argtypes = [c_void_p]
    lib.cmsCloseProfile.argtypes = [c_void_p]
    lib.cmsGetColorSpace.restype = c_uint32
    lib.cmsGetColorSpace.argtypes = [c_void_p]
    lib.cmsCreateGrayProfile.restype = c_void_p
    lib.cmsCreateGrayProfile.argtypes = [POINTER(_CIExyY), c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _linear_srgb_profile(lib):
    """Linear-gamma profile with sRGB primaries/white point (the
    XYB-side connection space, cms/jxl_cms.cc CreateProfileRGB analog)."""
    d65 = _CIExyY(0.3127, 0.3290, 1.0)
    prim = _CIExyYTRIPLE(_CIExyY(0.639998686, 0.330010138, 1.0),
                         _CIExyY(0.300003784, 0.600003357, 1.0),
                         _CIExyY(0.150002046, 0.059997204, 1.0))
    gamma = lib.cmsBuildGamma(None, 1.0)
    curves = (c_void_p * 3)(gamma, gamma, gamma)
    prof = lib.cmsCreateRGBProfile(ctypes.byref(d65), ctypes.byref(prim),
                                   curves)
    lib.cmsFreeToneCurve(gamma)
    return prof


def icc_to_linear_srgb(pixels: np.ndarray, icc: bytes) -> np.ndarray:
    """Convert (H, W, 3) pixels described by `icc` to linear sRGB floats.

    pixels: uint8/uint16 or float in [0, 1]. Returns f32 (H, W, 3).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("lcms2 not available")
    if pixels.dtype == np.uint8:
        src = pixels.astype(np.float32) / 255.0
    elif pixels.dtype == np.uint16:
        src = pixels.astype(np.float32) / 65535.0
    else:
        src = pixels.astype(np.float32)
    src = np.ascontiguousarray(src)
    h, w, _ = src.shape
    p_in = lib.cmsOpenProfileFromMem(icc, len(icc))
    if not p_in:
        raise ValueError("invalid ICC profile")
    p_out = _linear_srgb_profile(lib)
    xf = lib.cmsCreateTransform(p_in, TYPE_RGB_FLT, p_out, TYPE_RGB_FLT,
                                INTENT_RELATIVE_COLORIMETRIC, 0)
    lib.cmsCloseProfile(p_in)
    lib.cmsCloseProfile(p_out)
    if not xf:
        raise ValueError("cannot build ICC transform")
    out = np.empty_like(src)
    lib.cmsDoTransform(xf, src.ctypes.data_as(c_void_p),
                       out.ctypes.data_as(c_void_p), h * w)
    lib.cmsDeleteTransform(xf)
    return np.clip(out, 0.0, 1.0)


def linear_srgb_to_icc(pixels: np.ndarray, icc: bytes) -> np.ndarray:
    """Inverse of icc_to_linear_srgb: linear sRGB f32 (H, W, 3) ->
    f32 pixel values in the target profile's space (stage_cms analog)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("lcms2 not available")
    src = np.ascontiguousarray(pixels.astype(np.float32))
    h, w, _ = src.shape
    p_in = _linear_srgb_profile(lib)
    p_out = lib.cmsOpenProfileFromMem(icc, len(icc))
    if not p_out:
        lib.cmsCloseProfile(p_in)
        raise ValueError("invalid ICC profile")
    xf = lib.cmsCreateTransform(p_in, TYPE_RGB_FLT, p_out, TYPE_RGB_FLT,
                                INTENT_RELATIVE_COLORIMETRIC, 0)
    lib.cmsCloseProfile(p_in)
    lib.cmsCloseProfile(p_out)
    if not xf:
        raise ValueError("cannot build ICC transform")
    out = np.empty_like(src)
    lib.cmsDoTransform(xf, src.ctypes.data_as(c_void_p),
                       out.ctypes.data_as(c_void_p), h * w)
    lib.cmsDeleteTransform(xf)
    return np.clip(out, 0.0, 1.0)


def make_rgb_profile(primaries, white=(0.3127, 0.3290),
                     gamma: float = 2.2) -> bytes:
    """Serialize a simple RGB ICC profile (test helper / encoder tool).

    primaries: ((rx, ry), (gx, gy), (bx, by)) CIE xy chromaticities."""
    lib = _load()
    if lib is None:
        raise RuntimeError("lcms2 not available")
    lib.cmsSaveProfileToMem.argtypes = [c_void_p, c_void_p,
                                        POINTER(c_uint32)]
    wp = _CIExyY(white[0], white[1], 1.0)
    prim = _CIExyYTRIPLE(
        _CIExyY(primaries[0][0], primaries[0][1], 1.0),
        _CIExyY(primaries[1][0], primaries[1][1], 1.0),
        _CIExyY(primaries[2][0], primaries[2][1], 1.0))
    g = lib.cmsBuildGamma(None, gamma)
    curves = (c_void_p * 3)(g, g, g)
    prof = lib.cmsCreateRGBProfile(ctypes.byref(wp), ctypes.byref(prim),
                                   curves)
    lib.cmsFreeToneCurve(g)
    size = c_uint32(0)
    lib.cmsSaveProfileToMem(prof, None, ctypes.byref(size))
    buf = ctypes.create_string_buffer(size.value)
    lib.cmsSaveProfileToMem(prof, buf, ctypes.byref(size))
    lib.cmsCloseProfile(prof)
    return bytes(buf[:size.value])


def profile_color_space(icc: bytes) -> int:
    """ICC color-space signature ('RGB ' = 0x52474220,
    'GRAY' = 0x47524159, ...), or 0 when unreadable."""
    lib = _load()
    if lib is None:
        return 0
    p = lib.cmsOpenProfileFromMem(icc, len(icc))
    if not p:
        return 0
    cs = lib.cmsGetColorSpace(p)
    lib.cmsCloseProfile(p)
    return cs


def profile_is_rgb(icc: bytes) -> bool:
    lib = _load()
    if lib is None:
        return True
    return profile_color_space(icc) == 0x52474220  # 'RGB '


def profile_is_gray(icc: bytes) -> bool:
    return profile_color_space(icc) == 0x47524159  # 'GRAY'


def make_gray_profile(gamma: float = 2.2) -> bytes:
    """Serialize a simple grayscale ICC profile (D65, power TRC)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("lcms2 not available")
    d65 = _CIExyY(0.3127, 0.3290, 1.0)
    g = lib.cmsBuildGamma(None, float(gamma))
    prof = lib.cmsCreateGrayProfile(ctypes.byref(d65), g)
    lib.cmsFreeToneCurve(g)
    if not prof:
        raise RuntimeError("cannot create gray profile")
    lib.cmsSaveProfileToMem.argtypes = [c_void_p, c_void_p,
                                        POINTER(c_uint32)]
    n = c_uint32(0)
    lib.cmsSaveProfileToMem(prof, None, ctypes.byref(n))
    buf = ctypes.create_string_buffer(n.value)
    lib.cmsSaveProfileToMem(prof, buf, ctypes.byref(n))
    lib.cmsCloseProfile(prof)
    return buf.raw


def gray_icc_to_linear_srgb(pixels: np.ndarray, icc: bytes) -> np.ndarray:
    """(H, W) or (H, W, 1) gray samples described by a GRAY ICC profile
    -> linear sRGB f32 (H, W, 3) (jxl_cms.cc gray input leg)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("lcms2 not available")
    if pixels.ndim == 3:
        pixels = pixels[:, :, 0]
    if pixels.dtype == np.uint8:
        src = pixels.astype(np.float32) / 255.0
    elif pixels.dtype == np.uint16:
        src = pixels.astype(np.float32) / 65535.0
    else:
        src = pixels.astype(np.float32)
    src = np.ascontiguousarray(src)
    h, w = src.shape
    p_in = lib.cmsOpenProfileFromMem(icc, len(icc))
    if not p_in:
        raise ValueError("invalid ICC profile")
    p_out = _linear_srgb_profile(lib)
    xf = lib.cmsCreateTransform(p_in, TYPE_GRAY_FLT, p_out, TYPE_RGB_FLT,
                                INTENT_RELATIVE_COLORIMETRIC, 0)
    lib.cmsCloseProfile(p_in)
    lib.cmsCloseProfile(p_out)
    if not xf:
        raise ValueError("cannot build gray ICC transform")
    out = np.empty((h, w, 3), dtype=np.float32)
    lib.cmsDoTransform(xf, src.ctypes.data_as(c_void_p),
                       out.ctypes.data_as(c_void_p), h * w)
    lib.cmsDeleteTransform(xf)
    return np.clip(out, 0.0, 1.0)


def linear_srgb_to_gray_icc(pixels: np.ndarray, icc: bytes) -> np.ndarray:
    """linear sRGB f32 (H, W, 3) -> gray samples f32 (H, W) in the GRAY
    profile's space (decoder CMS stage, gray output leg)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("lcms2 not available")
    src = np.ascontiguousarray(pixels.astype(np.float32))
    h, w, _ = src.shape
    p_in = _linear_srgb_profile(lib)
    p_out = lib.cmsOpenProfileFromMem(icc, len(icc))
    if not p_out:
        lib.cmsCloseProfile(p_in)
        raise ValueError("invalid ICC profile")
    xf = lib.cmsCreateTransform(p_in, TYPE_RGB_FLT, p_out, TYPE_GRAY_FLT,
                                INTENT_RELATIVE_COLORIMETRIC, 0)
    lib.cmsCloseProfile(p_in)
    lib.cmsCloseProfile(p_out)
    if not xf:
        raise ValueError("cannot build gray ICC transform")
    out = np.empty((h, w), dtype=np.float32)
    lib.cmsDoTransform(xf, src.ctypes.data_as(c_void_p),
                       out.ctypes.data_as(c_void_p), h * w)
    lib.cmsDeleteTransform(xf)
    return np.clip(out, 0.0, 1.0)


TYPE_CMYK_FLT = (1 << 22) | (6 << 16) | (4 << 3) | 4  # PT_CMYK, 4xf32


def profile_is_cmyk(icc: bytes) -> bool:
    return profile_color_space(icc) == 0x434D594B  # 'CMYK'


def cmyk_icc_to_linear_srgb(ink: np.ndarray, icc: bytes) -> np.ndarray:
    """Convert (H, W, 4) CMYK ink fractions in [0, 1] described by a
    CMYK `icc` profile to linear sRGB f32 (H, W, 3). lcms float CMYK
    is scaled 0..100 (ink percent)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("lcms2 not available")
    src = np.ascontiguousarray(ink.astype(np.float32) * 100.0)
    h, w, _ = src.shape
    p_in = lib.cmsOpenProfileFromMem(icc, len(icc))
    if not p_in:
        raise ValueError("invalid ICC profile")
    p_out = _linear_srgb_profile(lib)
    xf = lib.cmsCreateTransform(p_in, TYPE_CMYK_FLT, p_out, TYPE_RGB_FLT,
                                INTENT_RELATIVE_COLORIMETRIC, 0)
    lib.cmsCloseProfile(p_in)
    lib.cmsCloseProfile(p_out)
    if not xf:
        raise ValueError("cannot build CMYK transform")
    out = np.empty((h, w, 3), dtype=np.float32)
    lib.cmsDoTransform(xf, src.ctypes.data_as(c_void_p),
                       out.ctypes.data_as(c_void_p), h * w)
    lib.cmsDeleteTransform(xf)
    return np.clip(out, 0.0, 1.0)
