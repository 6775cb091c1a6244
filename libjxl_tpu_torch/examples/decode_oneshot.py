"""One-shot decode example (examples/decode_oneshot.cc analog).

The decode runs on --device (the CUDA card by default: a missing card
raises; "cpu" runs the kernels' plain twins) or, under --host, on the
host.

Usage: python -m libjxl_tpu_torch.examples.decode_oneshot in.jxl out.png
       [--device cuda|cpu] [--host]
"""

import argparse
import sys

from ..api.codestream import decode
from ..base.device import add_device_args, cli_device
from ..extras.io import save_image
from ..io.container import extract_codestream


def main(argv=None):
    p = argparse.ArgumentParser(prog="decode_oneshot")
    p.add_argument("input")
    p.add_argument("output")
    add_device_args(p, "the decode")
    args = p.parse_args(argv)
    with open(args.input, "rb") as f:
        data = f.read()
    image, _meta = decode(extract_codestream(data), device=cli_device(args))
    save_image(args.output, image)
    print(f"decoded {image.shape[1]}x{image.shape[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
