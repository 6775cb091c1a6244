"""Top-level codestream encode/decode (signature | SizeHeader |
ImageMetadata | CustomTransformData | frames) of the one kind of stream
the benchmark makes: a bare codestream of one 8-bit sRGB VarDCT frame in
XYB, with no preview, ICC profile or extra channel.

Mirrors lib/jxl/decode.cc:1009-1231 (header parsing order) and
lib/jxl/encode.cc:803-940 (writer).
"""

from __future__ import annotations

import numpy as np

from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from ..io.frame_header import ENC_VARDCT, FrameHeader
from ..io.headers import CodecMetadata, CustomTransformData, ImageMetadata, SizeHeader

SIGNATURE = b"\xff\x0a"


def _calibrated_distance(distance: float) -> float:
    """Map the public --distance scale onto the internal quant scale.

    Round-3 state: after fixing the adaptive-quant field at the source
    (field computed pre-Gaborish like enc_heuristics.cc:1105, intra-block
    HfModulation diffs, the 0.39/d global-scale anchor, InitialQuantDC on
    the public distance, AdjustQuantField, learned DC trees), equal-
    butteraugli parity with the reference sits at a flat ~0.7x internal
    scale across d 0.5-3 (measured on textured/smooth/line corpora, see
    docs/RD_CURVE.md) — down from the round-2 0.5x + superlinear ramp
    patch. The residual 0.7 factor tracks our butteraugli comparator's
    absolute scale in the d -> quality mapping, not a field error."""
    return max(0.02, distance * 0.7)


def parse_codestream_header(r: BitReader) -> CodecMetadata:
    if r.read_bits(8) != 0xFF or r.read_bits(8) != 0x0A:
        raise JXLError("not a JPEG XL codestream (bad signature)")
    meta = CodecMetadata()
    meta.size = SizeHeader().read(r)
    meta.m = ImageMetadata().read(r)
    meta.transform_data = CustomTransformData(
        nonserialized_xyb_encoded=meta.m.xyb_encoded)
    meta.transform_data.read(r)
    if meta.m.color_encoding.want_icc:
        raise JXLError("an ICC profile: not in this copy")
    r.jump_to_byte_boundary()
    return meta


def write_codestream_header(w: BitWriter, meta: CodecMetadata) -> None:
    w.write(8, 0xFF)
    w.write(8, 0x0A)
    meta.size.write(w)
    meta.m.write(w)
    meta.transform_data.nonserialized_xyb_encoded = meta.m.xyb_encoded
    meta.transform_data.write(w)
    w.zero_pad_to_byte()


def encode_lossy(image: np.ndarray, distance: float = 1.0,
                 effort: int = 5, epf: int = None) -> bytes:
    """Encode an sRGB uint8 (H, W, 3) image lossily (VarDCT mode) at an
    effort from 1 to 5, on the host. epf: the EPF passes (default 2)."""
    from ..io.frame_header import CT_XYB, FT_REGULAR
    from ..ops.xyb import srgb_u8_to_linear
    from ..vardct.frame import encode_vardct_frame

    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise JXLError("an sRGB uint8 (H, W, 3) image only")
    if not 1 <= effort <= 5:
        raise JXLError("efforts 1-5 only")
    public_distance = distance
    distance = _calibrated_distance(distance)
    h, w, _ = image.shape
    meta = CodecMetadata()
    meta.size = SizeHeader().set(w, h)
    writer = BitWriter()
    write_codestream_header(writer, meta)
    fh = FrameHeader(meta)
    fh.all_default = False
    fh.frame_type = FT_REGULAR
    fh.encoding = ENC_VARDCT
    fh.color_transform = CT_XYB
    # adaptive DC smoothing enabled (flag clear): the decoder-side 3x3
    # DC filter averages out DC quantization noise on smooth content
    # (dc_dec smoothing, dec_frame.cc AdaptiveDCSmoothing)
    fh.flags = 0
    fh.loop_filter.all_default = False
    # decoder blurs; encoder pre-sharpens (default on, like the ref)
    fh.loop_filter.gab = True
    # reference default epf_iters = 2 (loop_filter.cc:56)
    fh.loop_filter.epf_iters = 2 if epf is None else max(0, min(3, epf))
    rgb = np.moveaxis(srgb_u8_to_linear(image), -1, 0)
    encode_vardct_frame(writer, rgb, fh, distance=distance,
                        effort=effort,
                        dc_distance=public_distance)
    return writer.get_bytes()


def decode(data: bytes):
    """Decode a bare codestream on the host (NumPy and native C). Returns
    (u8 image (H, W, 3), CodecMetadata)."""
    from ..io.frame_header import FT_REGULAR
    from ..ops.xyb import linear_to_srgb_u8
    from ..vardct.frame import decode_vardct_frame

    r = BitReader(data)
    meta = parse_codestream_header(r)
    m = meta.m
    if (m.have_preview or m.bit_depth.bits_per_sample > 8
            or not m.xyb_encoded or m.orientation != 1
            or m.extra_channel_info):
        raise JXLError("a preview, deep samples, no XYB, an orientation "
                       "or extra channels: not in this copy")
    fh = FrameHeader(meta)
    fh.read(r)
    if fh.frame_type != FT_REGULAR or fh.encoding != ENC_VARDCT:
        raise JXLError("a frame other than one regular VarDCT frame: not "
                       "in this copy")
    chans = decode_vardct_frame(r, fh)
    # transfer function + quantization fused into one threshold search
    return linear_to_srgb_u8(np.stack(chans, axis=-1)), meta
