"""Minimal OpenEXR scanline codec (extras/dec/exr.cc, enc/exr.cc role).

Covers the interchange subset the reference's EXR path uses: single-part
scanline images, half/float RGB(A), NONE or ZIP/ZIPS compression (via
zlib + the EXR byte-reorder predictor). Writer emits uncompressed half
scanlines. Pure NumPy; no OpenEXR library needed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..base.status import JXLError

_MAGIC = 0x01312F76

PIXEL_UINT, PIXEL_HALF, PIXEL_FLOAT = 0, 1, 2
_NO_COMPRESSION, _RLE, _ZIPS, _ZIP = 0, 1, 2, 3


def _read_cstr(data: bytes, pos: int):
    end = data.index(b"\0", pos)
    return data[pos:end].decode("latin-1"), end + 1


def _parse_channels(payload: bytes):
    chans = []
    pos = 0
    while payload[pos] != 0:
        name, pos = _read_cstr(payload, pos)
        ptype, _plin, xs, ys = struct.unpack_from("<iB3xii", payload, pos)
        pos += 16
        chans.append((name, ptype, xs, ys))
    return chans


def _unpredict(data: bytearray) -> bytes:
    """Inverse of the EXR zip predictor: delta-decode then de-interleave
    (ImfZip.cpp reconstruct + interleave)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8).astype(np.int64)
    arr = np.cumsum(np.concatenate([[arr[0]],
                                    (arr[1:] - 128) % 256])) % 256
    arr = arr.astype(np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    out = np.empty(n, dtype=np.uint8)
    out[0::2] = arr[:half]
    out[1::2] = arr[half:half + n // 2]
    return out.tobytes()


def load_exr(data: bytes):
    """-> (H, W, C) float32 array (linear light, RGB[A] order)."""
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise JXLError("not an EXR file")
    if version & 0x200:
        raise JXLError("multi-part EXR not supported")
    if version & 0x800:
        raise JXLError("deep EXR not supported")
    pos = 8
    channels = None
    compression = None
    dw = None
    while True:
        name, pos = _read_cstr(data, pos)
        if not name:
            break
        _atype, pos = _read_cstr(data, pos)
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        payload = data[pos:pos + size]
        pos += size
        if name == "channels":
            channels = _parse_channels(payload)
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            dw = struct.unpack("<4i", payload)
    if channels is None or dw is None or compression is None:
        raise JXLError("EXR header incomplete")
    if compression not in (_NO_COMPRESSION, _ZIPS, _ZIP):
        raise JXLError(f"EXR compression {compression} not supported")
    if any(xs != 1 or ys != 1 for _, _, xs, ys in channels):
        raise JXLError("EXR subsampled channels not supported")
    x0, y0, x1, y1 = dw
    w, h = x1 - x0 + 1, y1 - y0 + 1
    lines_per_block = 16 if compression == _ZIP else 1
    n_blocks = -(-h // lines_per_block)
    offsets = struct.unpack_from(f"<{n_blocks}q", data, pos)
    itemsize = {PIXEL_HALF: 2, PIXEL_FLOAT: 4, PIXEL_UINT: 4}
    dtypes = {PIXEL_HALF: np.float16, PIXEL_FLOAT: np.float32,
              PIXEL_UINT: np.uint32}
    # channel rows appear sorted by name within each scanline
    order = sorted(range(len(channels)), key=lambda i: channels[i][0])
    planes = {name: np.zeros((h, w), dtype=np.float32)
              for name, _, _, _ in channels}
    for off in offsets:
        y, size = struct.unpack_from("<ii", data, off)
        raw = data[off + 8:off + 8 + size]
        rows = min(lines_per_block, y1 - y + 1)
        expect = rows * sum(w * itemsize[channels[i][1]]
                            for i in range(len(channels)))
        if compression != _NO_COMPRESSION and size < expect:
            raw = _unpredict(bytearray(zlib.decompress(raw)))
        p = 0
        for r in range(rows):
            for i in order:
                name, ptype, _, _ = channels[i]
                nbytes = w * itemsize[ptype]
                row = np.frombuffer(raw[p:p + nbytes], dtype=dtypes[ptype])
                planes[name][y - y0 + r] = row.astype(np.float32)
                p += nbytes
    names = [c[0] for c in channels]
    stack = []
    for want in ("R", "G", "B", "A"):
        if want in names:
            stack.append(planes[want])
    if not stack:  # grayscale ("Y") or arbitrary single channel
        stack = [planes[names[0]]]
    return np.stack(stack, axis=-1)


def save_exr(image: np.ndarray) -> bytes:
    """(H, W, C>=1) float array -> uncompressed half-float EXR bytes."""
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, c = image.shape
    names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[c]
    out = bytearray(struct.pack("<ii", _MAGIC, 2))

    def attr(name, atype, payload):
        out.extend(name.encode() + b"\0" + atype.encode() + b"\0")
        out.extend(struct.pack("<i", len(payload)))
        out.extend(payload)

    ch = bytearray()
    for n in sorted(names):
        ch.extend(n.encode() + b"\0")
        ch.extend(struct.pack("<iBBBBii", PIXEL_HALF, 0, 0, 0, 0, 1, 1))
    ch.append(0)
    attr("channels", "chlist", bytes(ch))
    attr("compression", "compression", bytes([_NO_COMPRESSION]))
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    attr("dataWindow", "box2i", box)
    attr("displayWindow", "box2i", box)
    attr("lineOrder", "lineOrder", b"\0")
    attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    out.append(0)  # end of header
    table_pos = len(out)
    out.extend(b"\0" * 8 * h)
    halves = image.astype(np.float16)
    plane_of = {n: names.index(n) for n in names}
    offsets = []
    for y in range(h):
        offsets.append(len(out))
        row = bytearray()
        for n in sorted(names):
            row.extend(halves[y, :, plane_of[n]].tobytes())
        out.extend(struct.pack("<ii", y, len(row)))
        out.extend(row)
    struct.pack_into(f"<{h}q", out, table_pos, *offsets)
    return bytes(out)
