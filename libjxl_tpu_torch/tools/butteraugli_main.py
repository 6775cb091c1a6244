"""butteraugli CLI (tools/butteraugli_main.cc analog).

Usage: butteraugli orig.png distorted.png
Prints the approximate perceptual distance (higher = more different;
~1.0 is the visually-lossless threshold used by the encoder).

A .jxl input decodes on --device (the CUDA card by default: a missing
card raises; "cpu" runs the kernels' plain twins) or, under --host, on
the host. The metric is host NumPy, as in the reference.
"""

from __future__ import annotations

import argparse
import sys

from ..base.device import add_device_args, cli_device


def main(argv=None):
    p = argparse.ArgumentParser(prog="butteraugli")
    p.add_argument("orig", help="original image (png/pnm/npy/jxl)")
    p.add_argument("dist", help="distorted image")
    add_device_args(p, "a .jxl input's decode")
    args = p.parse_args(argv)
    device = cli_device(args)
    from ..extras.io import load_image
    from ..metrics import butteraugli_distance

    orig = load_image(args.orig, device=device)[:, :, :3]
    dist = load_image(args.dist, device=device)[:, :, :3]
    print(f"{butteraugli_distance(orig, dist):.8f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
