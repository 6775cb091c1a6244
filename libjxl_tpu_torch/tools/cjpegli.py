"""cjpegli — psychovisual JPEG encoder CLI (tools/cjpegli.cc analog).

A .jxl input decodes on --device (the CUDA card by default: a missing
card raises; "cpu" runs the kernels' plain twins) or, under --host, on
the host. The JPEG encode is host code.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..base.device import add_device_args, cli_device


def build_parser():
    p = argparse.ArgumentParser(
        prog="cjpegli", description="jpegli JPEG encoder")
    p.add_argument("input", help="input image (png/pnm/npy/...)")
    p.add_argument("output", help="output .jpg file")
    p.add_argument("-d", "--distance", type=float, default=None,
                   help="butteraugli target distance (default 1.0)")
    p.add_argument("-q", "--quality", type=int, default=None,
                   help="libjpeg-style quality 1-100 (overrides -d)")
    p.add_argument("--chroma_subsampling", default="444",
                   choices=["444", "420"],
                   help="chroma subsampling mode")
    p.add_argument("--std_quant", action="store_true",
                   help="use Annex-K standard quantization tables")
    p.add_argument("--noadaptive_quantization", action="store_true",
                   help="disable the adaptive dead-zone quantizer")
    p.add_argument("-p", "--progressive_level", type=int, default=0,
                   choices=[0, 1, 2],
                   help="0 = sequential (default), 1/2 = progressive "
                        "scan scripts")
    p.add_argument("--fixed_code", action="store_true",
                   help="use fixed Annex-K Huffman tables instead of "
                        "two-pass optimal codes")
    p.add_argument("-v", "--verbose", action="store_true")
    add_device_args(p, "a .jxl input's decode")
    return p


def main(argv=None):
    try:
        return _main(argv)
    except Exception as e:
        from ..base.status import JXLError

        if isinstance(e, (JXLError, OSError)):
            print(f"cjpegli: error: {e}", file=sys.stderr)
            return 1
        raise


def _main(argv):
    args = build_parser().parse_args(argv)
    from ..extras.io import load_image
    from ..jpegli import encode_jpegli

    img = load_image(args.input, device=cli_device(args))
    t0 = time.time()
    data = encode_jpegli(
        img,
        distance=args.distance,
        quality=args.quality,
        subsampling=args.chroma_subsampling,
        std_tables=args.std_quant,
        adaptive=not args.noadaptive_quantization,
        optimize=not args.fixed_code,
        progressive=args.progressive_level,
    )
    dt = time.time() - t0
    with open(args.output, "wb") as f:
        f.write(data)
    if args.verbose:
        mp = img.shape[0] * img.shape[1] / 1e6
        print(f"cjpegli: {len(data)} bytes, {dt:.3f} s "
              f"({mp / dt:.2f} MP/s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
