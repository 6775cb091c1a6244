"""ISOBMFF container: JXL signature/ftyp/jxll/jxlc/jxlp/Exif/xml/brob boxes.

Mirrors lib/jxl/encode.cc:803-1050 (writer), box_content_decoder.h and
decode.cc box parsing (reader). Brotli `brob` boxes are passed through
undecoded (brotli is not bundled; hook point documented).
"""

from __future__ import annotations

import struct

from ..base.status import JXLError, NotEnoughBytes

# 12-byte signature box + 20-byte ftyp box (encode_internal.h:145-148)
CONTAINER_HEADER = bytes([
    0, 0, 0, 0xC, 0x4A, 0x58, 0x4C, 0x20, 0xD, 0xA, 0x87, 0xA,
    0, 0, 0, 0x14, 0x66, 0x74, 0x79, 0x70, 0x6A, 0x78, 0x6C, 0x20,
    0, 0, 0, 0, 0x6A, 0x78, 0x6C, 0x20])
CODESTREAM_SIGNATURE = b"\xff\x0a"


def is_container(data: bytes) -> bool:
    return data[:12] == CONTAINER_HEADER[:12]


def is_codestream(data: bytes) -> bool:
    return data[:2] == CODESTREAM_SIGNATURE


def parse_boxes(data: bytes):
    """Yields (box_type: bytes, payload: bytes, unbounded: bool)."""
    pos = 0
    n = len(data)
    while pos < n:
        if pos + 8 > n:
            raise NotEnoughBytes("truncated box header")
        size = struct.unpack(">I", data[pos:pos + 4])[0]
        btype = data[pos + 4:pos + 8]
        header = 8
        if size == 1:
            if pos + 16 > n:
                raise NotEnoughBytes("truncated large box header")
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            header = 16
        if size == 0:  # unbounded: extends to EOF
            yield btype, data[pos + header:], True
            return
        if size < header or pos + size > n:
            raise JXLError("invalid box size")
        yield btype, data[pos + header:pos + size], False
        pos += size


def extract_codestream(data: bytes) -> bytes:
    """Returns the raw codestream bytes from either a bare codestream or a
    container (concatenating jxlp partial boxes / jxlc)."""
    if is_codestream(data):
        return data
    if not is_container(data):
        raise JXLError("not a JPEG XL file")
    parts = []
    for btype, payload, _ in parse_boxes(data[12:]):
        if btype == b"jxlc":
            parts.append(payload)
        elif btype == b"jxlp":
            # 4-byte counter (top bit = last)
            parts.append(payload[4:])
    if not parts:
        raise JXLError("container holds no codestream")
    return b"".join(parts)


def make_box(btype: bytes, payload: bytes, unbounded: bool = False) -> bytes:
    assert len(btype) == 4
    if unbounded:
        return struct.pack(">I", 0) + btype + payload
    size = 8 + len(payload)
    if size < (1 << 32):
        return struct.pack(">I", size) + btype + payload
    return struct.pack(">I", 1) + btype + struct.pack(">Q", 16 + len(payload)) \
        + payload


def wrap_codestream(codestream: bytes, level: int = 5, exif: bytes = None,
                    xml: bytes = None, compress_boxes: bool = False) -> bytes:
    """Builds a container file around a codestream (encode.cc:803-840).

    compress_boxes: wrap metadata boxes in Brotli `brob` boxes
    (encode.cc:871-905 brob writer)."""
    out = [CONTAINER_HEADER]
    if level != 5:
        out.append(make_box(b"jxll", bytes([level])))

    def meta_box(btype, payload):
        if compress_boxes:
            from .brotli import brotli_compress

            out.append(make_box(b"brob", btype + brotli_compress(payload)))
        else:
            out.append(make_box(btype, payload))

    if exif:
        meta_box(b"Exif", b"\x00\x00\x00\x00" + exif)
    if xml:
        meta_box(b"xml ", xml)
    out.append(make_box(b"jxlc", codestream))
    return b"".join(out)


def extract_metadata(data: bytes):
    """Returns dict of metadata boxes {"exif": ..., "xml": [...]}."""
    meta = {"exif": None, "xml": []}
    if not is_container(data):
        return meta
    for btype, payload, _ in parse_boxes(data[12:]):
        if btype == b"brob" and len(payload) >= 4:
            # Brotli-compressed metadata box (box_content_decoder.h:25)
            from .brotli import brotli_decompress

            btype, payload = payload[:4], brotli_decompress(payload[4:])
        if btype == b"Exif" and len(payload) >= 4:
            offset = struct.unpack(">I", payload[:4])[0]
            meta["exif"] = payload[4 + offset:]
        elif btype == b"xml ":
            meta["xml"].append(payload)
    return meta
