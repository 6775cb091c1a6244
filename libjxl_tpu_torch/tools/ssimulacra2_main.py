"""ssimulacra2 CLI (tools/ssimulacra2_main.cc analog).

Usage: ssimulacra2 orig.png distorted.png [--bg 0.5]
Prints the SSIMULACRA 2.1 score; exit code 0.

A .jxl input decodes on --device (the CUDA card by default: a missing
card raises; "cpu" runs the kernels' plain twins) or, under --host, on
the host. The metric is host NumPy, as in the reference.
"""

from __future__ import annotations

import argparse
import sys

from ..base.device import add_device_args, cli_device


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="ssimulacra2",
        description="Perceptual quality score: 100 = identical; "
        "30 = low, 50 = medium, 70 = high, 90 = visually lossless.")
    p.add_argument("orig", help="original image (png/pnm/npy/jxl)")
    p.add_argument("dist", help="distorted image")
    p.add_argument("--bg", type=float, default=0.5,
                   help="background intensity for alpha blending [0,1]")
    add_device_args(p, "a .jxl input's decode")
    args = p.parse_args(argv)
    device = cli_device(args)
    from ..extras.io import load_image
    from ..metrics import ssimulacra2

    orig = load_image(args.orig, device=device)
    dist = load_image(args.dist, device=device)
    print(f"{ssimulacra2(orig, dist, bg=args.bg):.8f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
