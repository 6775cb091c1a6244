"""HDR gain map bundle + standalone compressed-ICC API.

Mirrors lib/include/jxl/gain_map.h:76-118 (JxlGainMapBundle layout,
impl lib/extras/gain_map.cc:51-151) and the JxlICCProfileEncode/Decode
pair (lib/extras/compressed_icc.cc:13-33).

Bundle byte layout (big-endian sizes):
  u8   jhgm_version
  u16  gain_map_metadata_size | metadata bytes
  u8   color_encoding_size    | ColorEncoding bundle bits (byte-padded)
  u32  alt_icc_size           | compressed ICC bytes (icc_codec stream)
  rest: gain map codestream
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from ..io.headers import ColorEncoding


@dataclass
class GainMapBundle:
    jhgm_version: int = 0
    gain_map_metadata: bytes = b""
    color_encoding: ColorEncoding = None  # None = absent
    alt_icc: bytes = b""  # compressed (icc_codec) profile
    gain_map: bytes = b""  # naked JPEG XL codestream of the map


def write_gain_map_bundle(bundle: GainMapBundle) -> bytes:
    """JxlGainMapWriteBundle (gain_map.cc:82-151)."""
    ce_bytes = b""
    if bundle.color_encoding is not None:
        w = BitWriter()
        bundle.color_encoding.write(w)
        w.zero_pad_to_byte()
        ce_bytes = w.get_bytes()
        if len(ce_bytes) > 255:
            raise JXLError("color encoding too large for gain map bundle")
    out = bytearray()
    out.append(bundle.jhgm_version & 0xFF)
    out += struct.pack(">H", len(bundle.gain_map_metadata))
    out += bundle.gain_map_metadata
    out.append(len(ce_bytes))
    out += ce_bytes
    out += struct.pack(">I", len(bundle.alt_icc))
    out += bundle.alt_icc
    out += bundle.gain_map
    return bytes(out)


def read_gain_map_bundle(data: bytes) -> GainMapBundle:
    """JxlGainMapReadBundle (gain_map.cc:153-220)."""
    b = GainMapBundle()
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(data):
            raise JXLError("truncated gain map bundle")
        out = data[pos:pos + n]
        pos += n
        return out

    b.jhgm_version = take(1)[0]
    meta_size = struct.unpack(">H", take(2))[0]
    b.gain_map_metadata = take(meta_size)
    ce_size = take(1)[0]
    ce_bytes = take(ce_size)
    if ce_size:
        ce = ColorEncoding()
        ce.read(BitReader(ce_bytes))
        b.color_encoding = ce
    icc_size = struct.unpack(">I", take(4))[0]
    b.alt_icc = take(icc_size)
    b.gain_map = data[pos:]
    return b


# ------------------------------------------------- standalone compressed ICC
def icc_profile_encode(icc: bytes) -> bytes:
    """JxlICCProfileEncode (compressed_icc.cc:13-22): raw ICC -> the
    JPEG XL compressed-ICC representation (icc_codec stream bytes)."""
    from ..io.icc import write_icc

    w = BitWriter()
    write_icc(icc, w)
    w.zero_pad_to_byte()
    return w.get_bytes()


def icc_profile_decode(data: bytes) -> bytes:
    """JxlICCProfileDecode (compressed_icc.cc:24-33)."""
    from ..io.icc import read_icc

    return read_icc(BitReader(data))
