"""EXIF helpers: orientation parsing/reset (lib/extras/exif.{h,cc}).

The codestream carries its own orientation field (ImageMetadata);
embedded Exif blobs must have their orientation tag reset to 1 so the
two do not double-apply (ResetExifOrientation, exif.cc:21-51).
"""

from __future__ import annotations

import struct

import numpy as np


def _tiff_header(exif: bytes):
    if len(exif) < 8:
        return None
    if exif[:4] == b"II*\x00":
        return "<", 4
    if exif[:4] == b"MM\x00*":
        return ">", 4
    return None


def _find_orientation_offset(exif: bytes):
    hdr = _tiff_header(exif)
    if hdr is None:
        return None
    endian, _ = hdr
    ifd_off = struct.unpack(endian + "I", exif[4:8])[0]
    if ifd_off + 2 > len(exif):
        return None
    count = struct.unpack(endian + "H", exif[ifd_off:ifd_off + 2])[0]
    for i in range(count):
        e = ifd_off + 2 + 12 * i
        if e + 12 > len(exif):
            return None
        tag, typ, n = struct.unpack(endian + "HHI", exif[e:e + 8])
        if tag == 0x0112 and typ == 3 and n == 1:
            return endian, e + 8
    return None


def get_exif_orientation(exif: bytes) -> int:
    """-> orientation 1-8, or 1 when absent/invalid."""
    found = _find_orientation_offset(exif)
    if found is None:
        return 1
    endian, off = found
    v = struct.unpack(endian + "H", exif[off:off + 2])[0]
    return v if 1 <= v <= 8 else 1


def reset_exif_orientation(exif: bytes) -> bytes:
    """Set the Exif orientation tag to 1 (ResetExifOrientation)."""
    found = _find_orientation_offset(exif)
    if found is None:
        return exif
    endian, off = found
    out = bytearray(exif)
    out[off:off + 2] = struct.pack(endian + "H", 1)
    return bytes(out)


def apply_orientation(image: np.ndarray, orientation: int) -> np.ndarray:
    """Apply an EXIF/JXL orientation (1-8) to an (H, W, C) image —
    the decoder-side undo (dec_external_image orientation handling)."""
    if orientation <= 1:
        return image
    if orientation == 2:
        return image[:, ::-1]
    if orientation == 3:
        return image[::-1, ::-1]
    if orientation == 4:
        return image[::-1]
    if orientation == 5:
        return np.swapaxes(image, 0, 1)
    if orientation == 6:
        return np.swapaxes(image, 0, 1)[:, ::-1]
    if orientation == 7:
        return np.swapaxes(image, 0, 1)[::-1, ::-1]
    if orientation == 8:
        return np.swapaxes(image, 0, 1)[::-1]
    return image
