"""One-shot encode example (examples/encode_oneshot.cc analog).

A lossy encode, and the decode of a .jxl input, run on --device (the
CUDA card by default: a missing card raises; "cpu" runs the kernels'
plain twins) or, under --host, on the host. Distance 0 is a lossless
encode, which runs on the host.

Usage: python -m libjxl_tpu_torch.examples.encode_oneshot in.png out.jxl
       [distance] [--device cuda|cpu] [--host]
"""

import argparse
import sys

from ..api.codestream import encode_lossless, encode_lossy
from ..base.device import add_device_args, cli_device
from ..extras.io import load_image
from ..io.container import wrap_codestream


def main(argv=None):
    p = argparse.ArgumentParser(prog="encode_oneshot")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("distance", nargs="?", type=float, default=1.0)
    add_device_args(p, "the encode and a .jxl input's decode")
    args = p.parse_args(argv)
    device = cli_device(args)
    image, icc = load_image(args.input, return_icc=True, device=device)
    if args.distance == 0.0:
        data = encode_lossless(image, icc=icc)
    else:
        data = encode_lossy(image, distance=args.distance, icc=icc,
                            device=device)
    with open(args.output, "wb") as f:
        f.write(wrap_codestream(data))
    print(f"wrote {len(data)} codestream bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
