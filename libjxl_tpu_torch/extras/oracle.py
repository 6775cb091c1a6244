"""Interop oracle: ctypes bindings to a system-installed libjxl shared library.

This drives the *reference implementation* (the C library built from the code
surveyed in SURVEY.md — public API ``lib/include/jxl/decode.h`` /
``lib/include/jxl/encode.h``) so tests can validate this package's encoder and
decoder against it, closing the "all tests are self-roundtrip" gap:

  * our encoder -> oracle decoder   (lossless: bit-exact; lossy: RMSE bounds)
  * oracle encoder -> our decoder   (must match the oracle's own decode)

No headers are needed: struct layouts below mirror the stable 0.7+ ABI of
``jxl/types.h`` and ``jxl/codestream_header.h`` (JxlBasicInfo ends with 100
padding bytes precisely so it can be consumed this way).

Everything degrades gracefully: if no libjxl is installed, ``available()``
returns False and interop tests skip.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from ctypes import (POINTER, byref, c_char_p, c_double, c_float, c_int,
                    c_size_t, c_ubyte, c_uint8, c_uint32, c_void_p)

import numpy as np

# ---------------------------------------------------------------------------
# Library loading

_LIB_CANDIDATES = (
    "libjxl.so", "libjxl.so.0.7", "libjxl.so.0.8", "libjxl.so.0.9",
    "libjxl.so.0.10", "libjxl.so.0.11", "libjxl.dylib",
)

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    names = list(_LIB_CANDIDATES)
    found = ctypes.util.find_library("jxl")
    if found:
        names.insert(0, found)
    for name in names:
        try:
            _lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    if _lib is not None:
        _declare(_lib)
    return _lib


def available() -> bool:
    """True if a system libjxl could be loaded."""
    return _load() is not None


def version() -> tuple:
    lib = _load()
    if lib is None:
        return (0, 0, 0)
    v = lib.JxlDecoderVersion()
    return (v // 1000000, (v // 1000) % 1000, v % 1000)


# ---------------------------------------------------------------------------
# ABI mirrors (jxl/types.h, jxl/codestream_header.h, jxl/color_encoding.h)

JXL_TYPE_FLOAT = 0
JXL_TYPE_UINT8 = 2
JXL_TYPE_UINT16 = 3

JXL_NATIVE_ENDIAN = 0
JXL_LITTLE_ENDIAN = 1

# JxlDecoderStatus (decode.h:122-337)
JXL_DEC_SUCCESS = 0
JXL_DEC_ERROR = 1
JXL_DEC_NEED_MORE_INPUT = 2
JXL_DEC_NEED_PREVIEW_OUT_BUFFER = 3
JXL_DEC_NEED_IMAGE_OUT_BUFFER = 5
JXL_DEC_JPEG_NEED_MORE_OUTPUT = 6
JXL_DEC_BASIC_INFO = 0x40
JXL_DEC_COLOR_ENCODING = 0x100
JXL_DEC_PREVIEW_IMAGE = 0x200
JXL_DEC_FRAME = 0x400
JXL_DEC_FULL_IMAGE = 0x1000
JXL_DEC_JPEG_RECONSTRUCTION = 0x2000

# JxlEncoderStatus
JXL_ENC_SUCCESS = 0
JXL_ENC_ERROR = 1
JXL_ENC_NEED_MORE_OUTPUT = 2

JXL_ENC_FRAME_SETTING_EFFORT = 0
JXL_ENC_FRAME_SETTING_DECODING_SPEED = 1
JXL_ENC_FRAME_SETTING_RESAMPLING = 2
JXL_ENC_FRAME_SETTING_PHOTON_NOISE = 5
JXL_ENC_FRAME_SETTING_MODULAR = 11

JXL_COLOR_PROFILE_TARGET_ORIGINAL = 0
JXL_COLOR_PROFILE_TARGET_DATA = 1


class JxlPixelFormat(ctypes.Structure):
    _fields_ = [
        ("num_channels", c_uint32),
        ("data_type", c_int),
        ("endianness", c_int),
        ("align", c_size_t),
    ]


class JxlPreviewHeader(ctypes.Structure):
    _fields_ = [("xsize", c_uint32), ("ysize", c_uint32)]


class JxlAnimationHeader(ctypes.Structure):
    _fields_ = [
        ("tps_numerator", c_uint32),
        ("tps_denominator", c_uint32),
        ("num_loops", c_uint32),
        ("have_timecodes", c_int),
    ]


class JxlBasicInfo(ctypes.Structure):
    # codestream_header.h:95 (stable since 0.7: trailing padding[100])
    _fields_ = [
        ("have_container", c_int),
        ("xsize", c_uint32),
        ("ysize", c_uint32),
        ("bits_per_sample", c_uint32),
        ("exponent_bits_per_sample", c_uint32),
        ("intensity_target", c_float),
        ("min_nits", c_float),
        ("relative_to_max_display", c_int),
        ("linear_below", c_float),
        ("uses_original_profile", c_int),
        ("have_preview", c_int),
        ("have_animation", c_int),
        ("orientation", c_int),
        ("num_color_channels", c_uint32),
        ("num_extra_channels", c_uint32),
        ("alpha_bits", c_uint32),
        ("alpha_exponent_bits", c_uint32),
        ("alpha_premultiplied", c_int),
        ("preview", JxlPreviewHeader),
        ("animation", JxlAnimationHeader),
        ("intrinsic_xsize", c_uint32),
        ("intrinsic_ysize", c_uint32),
        ("padding", c_uint8 * 100),
    ]


class JxlColorEncoding(ctypes.Structure):
    # color_encoding.h:114
    _fields_ = [
        ("color_space", c_int),
        ("white_point", c_int),
        ("white_point_xy", c_double * 2),
        ("primaries", c_int),
        ("primaries_red_xy", c_double * 2),
        ("primaries_green_xy", c_double * 2),
        ("primaries_blue_xy", c_double * 2),
        ("transfer_function", c_int),
        ("gamma", c_double),
        ("rendering_intent", c_int),
    ]


def _declare(lib):
    lib.JxlDecoderVersion.restype = c_uint32
    lib.JxlDecoderCreate.restype = c_void_p
    lib.JxlDecoderCreate.argtypes = [c_void_p]
    lib.JxlDecoderDestroy.argtypes = [c_void_p]
    lib.JxlDecoderSubscribeEvents.argtypes = [c_void_p, c_int]
    lib.JxlDecoderSetInput.argtypes = [c_void_p, c_char_p, c_size_t]
    lib.JxlDecoderCloseInput.argtypes = [c_void_p]
    lib.JxlDecoderProcessInput.argtypes = [c_void_p]
    lib.JxlDecoderGetBasicInfo.argtypes = [c_void_p, POINTER(JxlBasicInfo)]
    lib.JxlDecoderImageOutBufferSize.argtypes = [
        c_void_p, POINTER(JxlPixelFormat), POINTER(c_size_t)]
    lib.JxlDecoderSetImageOutBuffer.argtypes = [
        c_void_p, POINTER(JxlPixelFormat), c_void_p, c_size_t]
    lib.JxlDecoderReleaseInput.restype = c_size_t
    lib.JxlDecoderReleaseInput.argtypes = [c_void_p]
    lib.JxlDecoderSetJPEGBuffer.argtypes = [c_void_p, c_void_p, c_size_t]
    lib.JxlDecoderReleaseJPEGBuffer.restype = c_size_t
    lib.JxlDecoderReleaseJPEGBuffer.argtypes = [c_void_p]
    lib.JxlDecoderGetICCProfileSize.argtypes = [
        c_void_p, POINTER(JxlPixelFormat), c_int, POINTER(c_size_t)]
    lib.JxlDecoderGetColorAsICCProfile.argtypes = [
        c_void_p, POINTER(JxlPixelFormat), c_int, c_void_p, c_size_t]

    lib.JxlEncoderCreate.restype = c_void_p
    lib.JxlEncoderCreate.argtypes = [c_void_p]
    lib.JxlEncoderDestroy.argtypes = [c_void_p]
    lib.JxlEncoderInitBasicInfo.argtypes = [POINTER(JxlBasicInfo)]
    lib.JxlEncoderSetBasicInfo.argtypes = [c_void_p, POINTER(JxlBasicInfo)]
    lib.JxlColorEncodingSetToSRGB.argtypes = [POINTER(JxlColorEncoding), c_int]
    lib.JxlEncoderSetColorEncoding.argtypes = [
        c_void_p, POINTER(JxlColorEncoding)]
    lib.JxlEncoderFrameSettingsCreate.restype = c_void_p
    lib.JxlEncoderFrameSettingsCreate.argtypes = [c_void_p, c_void_p]
    lib.JxlEncoderSetFrameDistance.argtypes = [c_void_p, c_float]
    lib.JxlEncoderFrameSettingsSetFloatOption.argtypes = [
        c_void_p, c_int, c_float]
    lib.JxlEncoderSetFrameLossless.argtypes = [c_void_p, c_int]
    lib.JxlEncoderFrameSettingsSetOption.argtypes = [
        c_void_p, c_int, ctypes.c_int64]
    lib.JxlEncoderAddImageFrame.argtypes = [
        c_void_p, POINTER(JxlPixelFormat), c_void_p, c_size_t]
    lib.JxlEncoderAddJPEGFrame.argtypes = [c_void_p, c_char_p, c_size_t]
    lib.JxlEncoderCloseInput.argtypes = [c_void_p]
    lib.JxlEncoderProcessOutput.argtypes = [
        c_void_p, POINTER(POINTER(c_ubyte)), POINTER(c_size_t)]
    lib.JxlEncoderUseContainer.argtypes = [c_void_p, c_int]
    lib.JxlEncoderStoreJPEGMetadata.argtypes = [c_void_p, c_int]


class OracleError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Decode

def decode(data: bytes, pixel_type: str = "uint8", want_jpeg: bool = False):
    """Decode `data` with the system libjxl.

    Returns (pixels, info_dict). pixels is (H, W, C) of the requested dtype
    (C = num_color_channels + 1 if there is an alpha channel).
    With want_jpeg=True, returns (jpeg_bytes, info_dict) when the stream
    carries JPEG reconstruction data.
    """
    lib = _load()
    if lib is None:
        raise OracleError("no system libjxl available")
    dtype = {"uint8": (JXL_TYPE_UINT8, np.uint8),
             "uint16": (JXL_TYPE_UINT16, np.uint16),
             "float": (JXL_TYPE_FLOAT, np.float32)}[pixel_type]
    dec = lib.JxlDecoderCreate(None)
    if not dec:
        raise OracleError("JxlDecoderCreate failed")
    try:
        events = JXL_DEC_BASIC_INFO | JXL_DEC_FULL_IMAGE
        if want_jpeg:
            events |= JXL_DEC_JPEG_RECONSTRUCTION
        if lib.JxlDecoderSubscribeEvents(dec, events) != JXL_DEC_SUCCESS:
            raise OracleError("SubscribeEvents failed")
        lib.JxlDecoderSetInput(dec, data, len(data))
        lib.JxlDecoderCloseInput(dec)

        info = JxlBasicInfo()
        fmt = JxlPixelFormat(0, dtype[0], JXL_LITTLE_ENDIAN, 0)
        out = None
        jpeg_buf = None
        jpeg_chunks = []
        while True:
            status = lib.JxlDecoderProcessInput(dec)
            if status == JXL_DEC_ERROR:
                raise OracleError("oracle decode error")
            if status == JXL_DEC_NEED_MORE_INPUT:
                raise OracleError("oracle: truncated input")
            if status == JXL_DEC_BASIC_INFO:
                if lib.JxlDecoderGetBasicInfo(dec, byref(info)) != 0:
                    raise OracleError("GetBasicInfo failed")
                nchan = info.num_color_channels
                if info.alpha_bits:
                    nchan += 1
                fmt.num_channels = nchan
            elif status == JXL_DEC_JPEG_RECONSTRUCTION:
                jpeg_buf = (c_ubyte * (1 << 20))()
                lib.JxlDecoderSetJPEGBuffer(dec, jpeg_buf, len(jpeg_buf))
            elif status == JXL_DEC_JPEG_NEED_MORE_OUTPUT:
                unused = lib.JxlDecoderReleaseJPEGBuffer(dec)
                jpeg_chunks.append(bytes(jpeg_buf)[:len(jpeg_buf) - unused])
                jpeg_buf = (c_ubyte * (1 << 21))()
                lib.JxlDecoderSetJPEGBuffer(dec, jpeg_buf, len(jpeg_buf))
            elif status == JXL_DEC_NEED_IMAGE_OUT_BUFFER:
                size = c_size_t()
                if lib.JxlDecoderImageOutBufferSize(
                        dec, byref(fmt), byref(size)) != 0:
                    raise OracleError("ImageOutBufferSize failed")
                out = np.empty(size.value // np.dtype(dtype[1]).itemsize,
                               dtype=dtype[1])
                if lib.JxlDecoderSetImageOutBuffer(
                        dec, byref(fmt),
                        out.ctypes.data_as(c_void_p), size.value) != 0:
                    raise OracleError("SetImageOutBuffer failed")
            elif status == JXL_DEC_FULL_IMAGE:
                continue
            elif status == JXL_DEC_SUCCESS:
                break
        info_d = {
            "xsize": info.xsize, "ysize": info.ysize,
            "bits_per_sample": info.bits_per_sample,
            "num_color_channels": info.num_color_channels,
            "num_extra_channels": info.num_extra_channels,
            "alpha_bits": info.alpha_bits,
            "uses_original_profile": bool(info.uses_original_profile),
            "have_animation": bool(info.have_animation),
            "intensity_target": info.intensity_target,
        }
        if want_jpeg and (jpeg_buf is not None or jpeg_chunks):
            if jpeg_buf is not None:
                unused = lib.JxlDecoderReleaseJPEGBuffer(dec)
                jpeg_chunks.append(bytes(jpeg_buf)[:len(jpeg_buf) - unused])
            return b"".join(jpeg_chunks), info_d
        if out is None:
            raise OracleError("no image produced")
        pixels = out.reshape(info.ysize, info.xsize, fmt.num_channels)
        return pixels, info_d
    finally:
        lib.JxlDecoderDestroy(dec)


# ---------------------------------------------------------------------------
# Encode

def encode(image: np.ndarray, distance: float = 1.0, effort: int = 7,
           lossless: bool = False, modular=None,
           photon_noise_iso: float = 0.0) -> bytes:
    """Encode (H, W, C) uint8/uint16 pixels with the system libjxl.

    Returns a bare codestream (no container) for lossy, container for none —
    the oracle emits whatever its defaults produce; our decoder handles both.
    """
    lib = _load()
    if lib is None:
        raise OracleError("no system libjxl available")
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, nc = image.shape
    if image.dtype == np.uint8:
        dt, bits = JXL_TYPE_UINT8, 8
    elif image.dtype == np.uint16:
        dt, bits = JXL_TYPE_UINT16, 16
    else:
        raise OracleError("uint8/uint16 input only")
    image = np.ascontiguousarray(image)

    enc = lib.JxlEncoderCreate(None)
    if not enc:
        raise OracleError("JxlEncoderCreate failed")
    try:
        info = JxlBasicInfo()
        lib.JxlEncoderInitBasicInfo(byref(info))
        info.xsize, info.ysize = w, h
        info.bits_per_sample = bits
        info.num_color_channels = 3 if nc >= 3 else 1
        if nc in (2, 4):
            info.num_extra_channels = 1
            info.alpha_bits = bits
        info.uses_original_profile = 1 if lossless else 0
        if lib.JxlEncoderSetBasicInfo(enc, byref(info)) != JXL_ENC_SUCCESS:
            raise OracleError("SetBasicInfo failed")
        color = JxlColorEncoding()
        lib.JxlColorEncodingSetToSRGB(byref(color), 1 if nc <= 2 else 0)
        if lib.JxlEncoderSetColorEncoding(enc, byref(color)) != 0:
            raise OracleError("SetColorEncoding failed")
        st = lib.JxlEncoderFrameSettingsCreate(enc, None)
        if lossless:
            lib.JxlEncoderSetFrameLossless(st, 1)
        else:
            lib.JxlEncoderSetFrameDistance(st, distance)
        lib.JxlEncoderFrameSettingsSetOption(
            st, JXL_ENC_FRAME_SETTING_EFFORT, effort)
        if modular is not None:
            lib.JxlEncoderFrameSettingsSetOption(
                st, JXL_ENC_FRAME_SETTING_MODULAR, 1 if modular else 0)
        if photon_noise_iso > 0:
            lib.JxlEncoderFrameSettingsSetFloatOption(
                st, JXL_ENC_FRAME_SETTING_PHOTON_NOISE,
                c_float(photon_noise_iso))
        fmt = JxlPixelFormat(nc, dt, JXL_LITTLE_ENDIAN, 0)
        # AddImageFrame takes the *frame settings* handle (encode.h:2412)
        if lib.JxlEncoderAddImageFrame(
                st, byref(fmt), image.ctypes.data_as(c_void_p),
                image.nbytes) != JXL_ENC_SUCCESS:
            raise OracleError("AddImageFrame failed")
        lib.JxlEncoderCloseInput(enc)
        return _drain(lib, enc)
    finally:
        lib.JxlEncoderDestroy(enc)


def butteraugli(orig: np.ndarray, dist: np.ndarray,
                pnorm: float = 3.0, hf_asymmetry: float = 0.8,
                intensity_target: float = 80.0):
    """Reference Butteraugli via the system library's C API
    (JxlButteraugliCompute; the exact comparator behind cjxl's quality
    loop, butteraugli/butteraugli.h:166-212).

    orig/dist: (H, W, 3) uint8 sRGB. Returns (max_distance,
    pnorm_distance); max_distance is the score cjxl/butteraugli_main
    report. Raises OracleError if the installed library predates or
    postdates the C Butteraugli API."""
    lib = _load()
    if lib is None:
        raise OracleError("no system libjxl available")
    if not hasattr(lib, "JxlButteraugliApiCreate"):
        raise OracleError("libjxl lacks the Butteraugli C API")
    lib.JxlButteraugliApiCreate.restype = c_void_p
    lib.JxlButteraugliApiCreate.argtypes = [c_void_p]
    lib.JxlButteraugliApiDestroy.argtypes = [c_void_p]
    lib.JxlButteraugliApiSetHFAsymmetry.argtypes = [c_void_p, c_float]
    lib.JxlButteraugliApiSetIntensityTarget.argtypes = [c_void_p, c_float]
    lib.JxlButteraugliCompute.restype = c_void_p
    lib.JxlButteraugliCompute.argtypes = [
        c_void_p, c_uint32, c_uint32, POINTER(JxlPixelFormat), c_void_p,
        c_size_t, POINTER(JxlPixelFormat), c_void_p, c_size_t]
    lib.JxlButteraugliResultGetDistance.restype = c_float
    lib.JxlButteraugliResultGetDistance.argtypes = [c_void_p, c_float]
    lib.JxlButteraugliResultGetMaxDistance.restype = c_float
    lib.JxlButteraugliResultGetMaxDistance.argtypes = [c_void_p]
    lib.JxlButteraugliResultDestroy.argtypes = [c_void_p]

    orig = np.ascontiguousarray(orig[:, :, :3], dtype=np.uint8)
    dist = np.ascontiguousarray(dist[:, :, :3], dtype=np.uint8)
    if orig.shape != dist.shape:
        raise OracleError("butteraugli: shape mismatch")
    h, w = orig.shape[:2]
    fmt = JxlPixelFormat(3, JXL_TYPE_UINT8, JXL_NATIVE_ENDIAN, 0)
    api = lib.JxlButteraugliApiCreate(None)
    if not api:
        raise OracleError("JxlButteraugliApiCreate failed")
    try:
        lib.JxlButteraugliApiSetHFAsymmetry(api, hf_asymmetry)
        lib.JxlButteraugliApiSetIntensityTarget(api, intensity_target)
        res = lib.JxlButteraugliCompute(
            api, w, h, byref(fmt),
            orig.ctypes.data_as(c_void_p), orig.nbytes,
            byref(fmt), dist.ctypes.data_as(c_void_p), dist.nbytes)
        if not res:
            raise OracleError("JxlButteraugliCompute failed")
        try:
            mx = float(lib.JxlButteraugliResultGetMaxDistance(res))
            pn = float(lib.JxlButteraugliResultGetDistance(res, pnorm))
        finally:
            lib.JxlButteraugliResultDestroy(res)
        return mx, pn
    finally:
        lib.JxlButteraugliApiDestroy(api)


def encode_jpeg(jpeg_bytes: bytes, effort: int = 7) -> bytes:
    """Losslessly recompress a JPEG file with the system libjxl.

    Returns a container stream with JPEG reconstruction metadata.
    """
    lib = _load()
    if lib is None:
        raise OracleError("no system libjxl available")
    enc = lib.JxlEncoderCreate(None)
    if not enc:
        raise OracleError("JxlEncoderCreate failed")
    try:
        lib.JxlEncoderUseContainer(enc, 1)
        lib.JxlEncoderStoreJPEGMetadata(enc, 1)
        st = lib.JxlEncoderFrameSettingsCreate(enc, None)
        lib.JxlEncoderFrameSettingsSetOption(
            st, JXL_ENC_FRAME_SETTING_EFFORT, effort)
        if lib.JxlEncoderAddJPEGFrame(
                st, jpeg_bytes, len(jpeg_bytes)) != JXL_ENC_SUCCESS:
            raise OracleError("AddJPEGFrame failed")
        lib.JxlEncoderCloseInput(enc)
        return _drain(lib, enc)
    finally:
        lib.JxlEncoderDestroy(enc)


def _drain(lib, enc) -> bytes:
    chunks = []
    buf = (c_ubyte * (1 << 20))()
    while True:
        next_out = ctypes.cast(buf, POINTER(c_ubyte))
        avail = c_size_t(len(buf))
        status = lib.JxlEncoderProcessOutput(
            enc, byref(next_out), byref(avail))
        produced = len(buf) - avail.value
        chunks.append(bytes(buf)[:produced])
        if status == JXL_ENC_SUCCESS:
            return b"".join(chunks)
        if status != JXL_ENC_NEED_MORE_OUTPUT:
            raise OracleError("oracle encode error")
