"""External image formats: PNG (via PIL), PNM/PGM/PPM/PFM, NPY, PGX.

Mirrors lib/extras/dec/*.cc + enc/*.cc surface (PackedPixelFile analog is
a plain numpy array + metadata dict).
"""

from __future__ import annotations

import pathlib
import struct

import numpy as np

from ..base.status import JXLError


def load_image(path, return_icc: bool = False, device="cuda"):
    """Returns (H, W, C) uint8/uint16 array; with return_icc=True returns
    (array, icc_bytes_or_None) — the embedded ICC profile if present.

    device: where a .jxl input's pixel pipeline runs, passed to
    api.codestream.decode: "cuda" by default (a missing card raises),
    "cpu" the plain twins, None the host decode. Other formats ignore
    it."""
    path = pathlib.Path(path)
    suffix = path.suffix.lower()
    if suffix in (".pnm", ".ppm", ".pgm"):
        arr = _load_pnm(path.read_bytes())
        return (arr, None) if return_icc else arr
    if suffix == ".pgx":
        arr = _load_pgx(path.read_bytes())
        return (arr, None) if return_icc else arr
    if suffix == ".pfm":
        arr = _load_pfm(path.read_bytes())
        return (arr, None) if return_icc else arr
    if suffix == ".npy":
        arr = np.load(path)
        return (arr, None) if return_icc else arr
    if suffix == ".exr":
        from .exr import load_exr

        arr = load_exr(path.read_bytes())
        return (arr, None) if return_icc else arr
    if suffix == ".jxl":
        from ..api.codestream import decode
        from ..io.container import extract_codestream, is_container

        data = path.read_bytes()
        if is_container(data):
            data = extract_codestream(data)
        arr, _meta = decode(data, device=device)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return (arr, None) if return_icc else arr
    try:
        from PIL import Image

        img = Image.open(path)
        if suffix == ".png" and img.mode in ("RGB", "RGBA", "LA") \
                and _png_bit_depth(path) == 16:
            # PIL silently truncates multi-channel 16-bit PNGs to 8
            arr = _load_png16(path.read_bytes())
            if return_icc:
                return arr, img.info.get("icc_profile")
            return arr
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if return_icc:
            return arr, img.info.get("icc_profile")
        return arr
    except ImportError as e:  # pragma: no cover
        raise JXLError(f"cannot load {path}: PIL unavailable") from e


def _png_bit_depth(path) -> int:
    with open(path, "rb") as f:
        head = f.read(25)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or len(head) < 25:
        return 0
    return head[24]


def _load_png16(data: bytes) -> np.ndarray:
    """Pure-Python 16-bit PNG reader (all scanline filters, no
    interlace): PIL has no 16-bit multi-channel mode."""
    import struct
    import zlib

    pos = 8
    w = h = None
    nc = 0
    idat = []
    while pos + 8 <= len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, _comp, _filt, interlace = \
                struct.unpack(">IIBBBBB", payload)
            if depth != 16 or interlace:
                raise JXLError("unsupported 16-bit PNG layout")
            nc = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    raw = zlib.decompress(b"".join(idat))
    bpp = nc * 2
    stride = w * bpp
    out = np.empty((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    off = 0
    for y in range(h):
        ftype = raw[off]
        row = np.frombuffer(raw, np.uint8, stride, off + 1).copy()
        off += 1 + stride
        if ftype == 1:  # Sub
            for x in range(bpp, stride):
                row[x] = (row[x] + row[x - bpp]) & 0xFF
        elif ftype == 2:  # Up
            row += prev
        elif ftype == 3:  # Average
            for x in range(stride):
                left = row[x - bpp] if x >= bpp else 0
                row[x] = (row[x] + ((int(left) + int(prev[x])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for x in range(stride):
                a = int(row[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                        else c)
                row[x] = (row[x] + pred) & 0xFF
        out[y] = row
        prev = row
    return out.reshape(h, w, nc, 2).astype(np.uint16) \
        .__mul__(np.array([256, 1], dtype=np.uint16)).sum(
            axis=-1, dtype=np.uint16)


def load_animation(path):
    """GIF/APNG frames -> (frames list of (H, W, C) uint8, durations_ms).

    The extras/dec/{gif,apng}.cc reading surface, via PIL."""
    from PIL import Image, ImageSequence

    img = Image.open(pathlib.Path(path))
    frames, durations = [], []
    for frame in ImageSequence.Iterator(img):
        f = frame.convert("RGBA" if "A" in frame.getbands()
                          or frame.info.get("transparency") is not None
                          else "RGB")
        frames.append(np.asarray(f))
        durations.append(int(frame.info.get("duration", 100)))
    return frames, durations


def save_image(path, image: np.ndarray, icc: bytes = None) -> None:
    path = pathlib.Path(path)
    suffix = path.suffix.lower()
    if suffix in (".pnm", ".ppm", ".pgm"):
        path.write_bytes(_save_pnm(image))
        return
    if suffix == ".pgx":
        path.write_bytes(_save_pgx(image))
        return
    if suffix == ".pfm":
        path.write_bytes(_save_pfm(image))
        return
    if suffix == ".npy":
        np.save(path, image)
        return
    if suffix == ".exr":
        from .exr import save_exr

        img = image
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        elif img.dtype == np.uint16:
            img = img.astype(np.float32) / 65535.0
        path.write_bytes(save_exr(img))
        return
    if image.dtype == np.uint16 and suffix == ".png" \
            and not (image.ndim == 2
                     or (image.ndim == 3 and image.shape[2] == 1)):
        # PIL writes 16-bit PNG only for grayscale ('I;16'); multi-
        # channel 16-bit goes through our own writer
        path.write_bytes(_save_png16(image, icc))
        return
    from PIL import Image

    if image.ndim == 3 and image.shape[2] == 1:
        image = image[:, :, 0]
    kw = {"icc_profile": icc} if icc else {}
    Image.fromarray(image).save(path, **kw)


def _save_png16(image: np.ndarray, icc: bytes = None) -> bytes:
    """Minimal 16-bit PNG writer (color types 0/2/4/6, filter 0).

    PIL cannot produce multi-channel 16-bit PNGs; djxl/djpegli 16-bit
    output needs them (PNG spec: big-endian samples)."""
    import struct
    import zlib

    if image.ndim == 2:
        image = image[:, :, None]
    h, w, nc = image.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[nc]

    def chunk(tag, payload):
        raw = tag + payload
        return (struct.pack(">I", len(payload)) + raw
                + struct.pack(">I", zlib.crc32(raw) & 0xFFFFFFFF))

    out = [b"\x89PNG\r\n\x1a\n",
           chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, color_type,
                                      0, 0, 0))]
    if icc:
        out.append(chunk(b"iCCP", b"icc\x00\x00" + zlib.compress(icc)))
    be = np.ascontiguousarray(image.astype(">u2"))
    rows = be.reshape(h, w * nc * 2 // 2).view(np.uint8).reshape(h, -1)
    scan = np.concatenate(
        [np.zeros((h, 1), dtype=np.uint8), rows], axis=1)
    out.append(chunk(b"IDAT", zlib.compress(scan.tobytes(), 6)))
    out.append(chunk(b"IEND", b""))
    return b"".join(out)


def _load_pnm(data: bytes) -> np.ndarray:
    if not data.startswith(b"P"):
        raise JXLError("not a PNM file")
    fields = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1
    w, h, maxval = fields
    kind = data[1:2]
    channels = 3 if kind == b"6" else 1
    dtype = np.uint16 if maxval > 255 else np.uint8
    count = w * h * channels
    arr = np.frombuffer(data, dtype=">u2" if maxval > 255 else np.uint8,
                        count=count, offset=pos)
    return arr.astype(dtype).reshape(h, w, channels)


def _save_pnm(image: np.ndarray) -> bytes:
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, c = image.shape
    maxval = 65535 if image.dtype == np.uint16 else 255
    magic = b"P6" if c == 3 else b"P5"
    header = b"%s\n%d %d\n%d\n" % (magic, w, h, maxval)
    data = image.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return header + data


def _load_pgx(data: bytes) -> np.ndarray:
    """PGX (JPEG 2000 test-set grayscale raw): 'PG <ML|LM> <+|-> bits
    w h\\n' then raw samples (lib/extras/dec/pgx.cc:90-140)."""
    if not data.startswith(b"PG"):
        raise JXLError("not a PGX file")
    # header is ASCII up to the first newline
    nl = data.find(b"\n")
    if nl < 0:
        raise JXLError("PGX: truncated header")
    fields = data[2:nl].strip().split()
    if len(fields) == 4:  # "ML +16" fused sign+bits
        endian, signbits, w, h = fields
        sign, bits = signbits[:1], signbits[1:]
    elif len(fields) == 5:
        endian, sign, bits, w, h = fields
    else:
        raise JXLError("PGX: bad header")
    if endian not in (b"ML", b"LM"):
        raise JXLError("PGX: invalid endianness")
    if sign == b"-":
        raise JXLError("PGX: signed not supported")
    if sign != b"+":
        raise JXLError("PGX: invalid signedness")
    bits, w, h = int(bits), int(w), int(h)
    if bits > 16:
        raise JXLError("PGX: >16 bits not supported")
    dt = (">u2" if endian == b"ML" else "<u2") if bits > 8 else "u1"
    arr = np.frombuffer(data, dtype=dt, count=w * h, offset=nl + 1)
    return arr.astype(np.uint16 if bits > 8 else np.uint8).reshape(h, w, 1)


def _save_pgx(image: np.ndarray) -> bytes:
    """Writes 'PG ML + bits w h' + big-endian samples
    (lib/extras/enc/pgx.cc:37)."""
    if image.ndim == 3:
        if image.shape[2] != 1:
            raise JXLError("PGX is grayscale only")
        image = image[:, :, 0]
    h, w = image.shape
    bits = 16 if image.dtype == np.uint16 else 8
    header = b"PG ML + %d %d %d\n" % (bits, w, h)
    return header + image.astype(">u2" if bits == 16 else "u1").tobytes()


def _load_pfm(data: bytes) -> np.ndarray:
    """PFM float maps: 'PF|Pf\\nw h\\nscale\\n' + float32 rows
    bottom-up; negative scale = little-endian (dec/pnm.cc PFM path)."""
    if data[:2] not in (b"PF", b"Pf"):
        raise JXLError("not a PFM file")
    channels = 3 if data[:2] == b"PF" else 1
    pos = 2
    fields = []
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        start = pos
        while not data[pos:pos + 1].isspace():
            pos += 1
        fields.append(data[start:pos])
    pos += 1
    w, h = int(fields[0]), int(fields[1])
    scale = float(fields[2])
    dt = "<f4" if scale < 0 else ">f4"
    arr = np.frombuffer(data, dtype=dt, count=w * h * channels, offset=pos)
    arr = arr.astype(np.float32).reshape(h, w, channels)
    return arr[::-1]  # PFM stores rows bottom-up


def _save_pfm(image: np.ndarray) -> bytes:
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, c = image.shape
    if c not in (1, 3):
        raise JXLError("PFM supports 1 or 3 channels")
    magic = b"PF" if c == 3 else b"Pf"
    header = b"%s\n%d %d\n-1.0\n" % (magic, w, h)
    return header + image[::-1].astype("<f4").tobytes()
