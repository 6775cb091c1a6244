"""Fuzz harness for the decoder surfaces.

Mirrors the reference's fuzzer family (tools/*_fuzzer.cc: djxl_fuzzer,
rans_fuzzer, icc_codec_fuzzer, fields_fuzzer...). Feeds random and
mutated inputs to each target; any exception other than the library's
typed error (JXLError and its subclasses) is a finding: a device
RuntimeError, a kernel wrapper's ValueError or torch.OutOfMemoryError is
never a clean rejection.

The decode and encode targets, and the seed corpus the decode and
container targets mutate, run on --device (the CUDA card by default: a
missing card raises; "cpu" runs the kernels' plain twins) or, under
--host, on the host. The streaming encoder has no host route, so under
--host the corpus's streaming stream is made on "cpu". Nothing probes
the device: a fuzzed stream that passes the host parse renders on the
device whatever its size, unless a scope gate of the render keeps it on
the host, as in api.codestream.decode.

Usage: python -m libjxl_tpu_torch.tools.fuzz [--target all] [--iters 200]
       [--seed 0] [--device cuda|cpu] [--host]
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np

from ..base.device import add_device_args, cli_device, launch_counts
from ..base.status import JXLError


def _ok(exc: BaseException) -> bool:
    return isinstance(exc, JXLError)


def fuzz_decode(data: bytes, device="cuda") -> None:
    from ..api.codestream import decode

    decode(data, device=device)


def fuzz_container(data: bytes) -> None:
    from ..io.container import is_container, parse_boxes

    if is_container(data):
        parse_boxes(data[12:])


def fuzz_entropy(data: bytes) -> None:
    from ..entropy.decode import ANSSymbolReader, decode_histograms
    from ..io.bits import BitReader

    r = BitReader(data)
    code, cmap = decode_histograms(r, 1 + (data[0] % 8 if data else 0))
    reader = ANSSymbolReader(code, r)
    for _ in range(64):
        reader.read_hybrid_uint(0, r, cmap)


def fuzz_fields(data: bytes) -> None:
    from ..io.bits import BitReader
    from ..io.frame_header import FrameHeader
    from ..io.headers import CodecMetadata, ImageMetadata, SizeHeader

    r = BitReader(data)
    meta = CodecMetadata()
    meta.size = SizeHeader().read(r)
    meta.m = ImageMetadata().read(r)
    FrameHeader(meta).read(r)


def fuzz_icc(data: bytes) -> None:
    from ..io.bits import BitReader
    from ..io.icc import read_icc

    read_icc(BitReader(data))


def fuzz_jpeg(data: bytes) -> None:
    from ..jpeg.data import parse_jpeg

    parse_jpeg(data)


def fuzz_jpegli_dec(data: bytes) -> None:
    """jpegli_dec_fuzzer analog: full float decode of arbitrary JPEG
    bytes (parse + dequant + IDCT + upsample)."""
    from ..jpegli import decode_jpegli

    decode_jpegli(data)


def fuzz_color_encoding(data: bytes) -> None:
    """color_encoding_fuzzer analog: parse a ColorEncoding bundle."""
    from ..io.bits import BitReader
    from ..io.headers import ColorEncoding

    ColorEncoding().read(BitReader(data))


def fuzz_basic_info(data: bytes) -> None:
    """decode_basic_info_fuzzer analog: signature + size + metadata."""
    from ..api.codestream import parse_codestream_header
    from ..io.bits import BitReader

    parse_codestream_header(BitReader(data))


def fuzz_tree(data: bytes) -> None:
    """MA-tree decode (part of transforms/modular fuzzing surface)."""
    from ..io.bits import BitReader
    from ..modular.tree import decode_tree

    decode_tree(BitReader(data), tree_size_limit=1024)


def fuzz_brotli(data: bytes) -> None:
    """brob box decompression path (our RFC 7932 subset decoder)."""
    from ..io.brotli import brotli_decode

    brotli_decode(data, max_output=1 << 20)


def fuzz_image_io(data: bytes) -> None:
    """PNM/PGX header parsers on arbitrary bytes."""
    from ..extras.io import _load_pgx, _load_pnm

    try:
        _load_pnm(data)
    except (JXLError, ValueError, IndexError):
        # header-grammar rejections; ValueError/IndexError wrapped below
        pass
    _load_pgx(data)


def fuzz_encode(data: bytes, device="cuda") -> None:
    """cjxl_fuzzer analog: encode a small image whose pixels and
    options derive from the fuzz input; encoder must never raise. The
    lossy encode and the decode run on `device`."""
    from ..api.codestream import decode, encode_lossless, encode_lossy

    if len(data) < 8:
        return
    h = 1 + data[0] % 24
    w = 1 + data[1] % 24
    opts = data[2]
    n = h * w * 3
    buf = np.frombuffer((data[3:] * (n // max(1, len(data) - 3) + 1))[:n],
                        dtype=np.uint8).reshape(h, w, 3)
    if opts & 1:
        out = encode_lossless(buf)
    else:
        out = encode_lossy(buf, distance=0.5 + (opts >> 1) % 8,
                           device=device)
    decode(out, device=device)


TARGETS = {
    "decode": fuzz_decode,
    "container": fuzz_container,
    "entropy": fuzz_entropy,
    "fields": fuzz_fields,
    "icc": fuzz_icc,
    "jpeg": fuzz_jpeg,
    "jpegli_dec": fuzz_jpegli_dec,
    "color_encoding": fuzz_color_encoding,
    "basic_info": fuzz_basic_info,
    "tree": fuzz_tree,
    "brotli": fuzz_brotli,
    "image_io": fuzz_image_io,
    "encode": fuzz_encode,
}
# the targets that take a device
DEVICE_TARGETS = ("decode", "encode")


def _seed_corpus(device="cuda") -> list:
    """Valid streams to mutate (mutation fuzzing beats pure random).

    Includes a MULTI-GROUP stream (several AC-group TOC sections — the
    native bulk decoder's per-group offset/selector validation paths)
    and a streaming-encoder stream (num_histograms > 1 per DC group),
    not just the single-section special case. The e5 lossy stream is
    encoded on `device`, the multi-group e3 one on the host (as in the
    reference), the streaming one on `device`, or on "cpu" when `device`
    is None (the streaming encoder has no host route). A failed build
    raises."""
    from ..api.codestream import (
        encode_lossless,
        encode_lossy,
        encode_lossy_streaming,
    )

    rng = np.random.default_rng(42)
    img = np.clip(rng.normal(128, 40, (32, 40, 3)), 0, 255).astype(np.uint8)
    out = [encode_lossless(img),
           encode_lossy(img, distance=2.0, device=device)]
    big = np.clip(
        128 + 60 * np.sin(np.arange(320)[:, None] * 0.04)
        + rng.normal(0, 10, (320, 280)), 0, 255
    ).astype(np.uint8)[:, :, None].repeat(3, axis=2)
    out.append(encode_lossy(big, distance=1.0, effort=3, device=None))
    out.append(encode_lossy_streaming(
        big, distance=1.0, device="cpu" if device is None else device))
    return out


def run(target: str, iters: int, seed: int, max_len: int = 4096,
        device="cuda", stats: dict = None) -> int:
    """-> number of findings (non-JXLError exceptions).

    device: where the decode and encode targets and the decode/container
    seed corpus run (None: the host). stats: pass a dict to receive
    {"inputs", "rejected" (clean JXLError rejections), "reached_kernel"
    (inputs during which a device kernel launched: the launch counters of
    base/device moved)}."""
    rng = np.random.default_rng(seed)
    fn = TARGETS[target]
    if target in DEVICE_TARGETS:
        fn = functools.partial(fn, device=device)
    corpus = []
    if target in ("decode", "container"):
        corpus = _seed_corpus(device)
    elif target in ("jpeg", "jpegli_dec"):
        from ..jpegli import encode_jpegli

        img = np.clip(np.random.default_rng(1).normal(
            128, 40, (24, 40, 3)), 0, 255).astype(np.uint8)
        corpus = [encode_jpegli(img, distance=2.0),
                  encode_jpegli(img, distance=2.0, progressive=2,
                                subsampling="420")]
    if stats is None:
        stats = {}
    stats.update(inputs=0, rejected=0, reached_kernel=0)
    findings = 0
    for i in range(iters):
        kind = int(rng.integers(0, 3)) if corpus else 0
        if kind == 0:  # pure random
            n = int(rng.integers(1, max_len))
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        elif kind == 1:  # truncation of a valid stream
            base = corpus[int(rng.integers(0, len(corpus)))]
            data = base[:int(rng.integers(1, len(base)))]
        else:  # byte flips in a valid stream
            base = bytearray(corpus[int(rng.integers(0, len(corpus)))])
            for _ in range(int(rng.integers(1, 16))):
                base[int(rng.integers(0, len(base)))] = int(
                    rng.integers(0, 256))
            data = bytes(base)
        launched = sum(launch_counts().values())
        stats["inputs"] += 1
        try:
            fn(data)
        except Exception as e:  # noqa: BLE001 - the point of a fuzzer
            if not _ok(e):
                findings += 1
                print(f"[{target}] iter {i}: {type(e).__name__}: {e}",
                      file=sys.stderr)
            else:
                stats["rejected"] += 1
        finally:
            if sum(launch_counts().values()) > launched:
                stats["reached_kernel"] += 1
    return findings


def main(argv=None):
    p = argparse.ArgumentParser(description="decoder fuzz harness")
    p.add_argument("--target", default="all",
                   choices=["all", *TARGETS.keys()])
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    add_device_args(p, "the decode and encode targets")
    args = p.parse_args(argv)
    targets = list(TARGETS) if args.target == "all" else [args.target]
    total = 0
    for t in targets:
        n = run(t, args.iters, args.seed, device=cli_device(args))
        print(f"{t}: {args.iters} iters, {n} findings")
        total += n
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())
