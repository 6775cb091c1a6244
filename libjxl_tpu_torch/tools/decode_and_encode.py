"""decode_and_encode CLI (tools/decode_and_encode.cc analog):
decode any supported input and re-encode to the output path's format —
a format-conversion pipe used by conformance/fuzz pipelines.

A .jxl input decodes on --device (the CUDA card by default: a missing
card raises; "cpu" runs the kernels' plain twins) or, under --host, on
the host. A .jxl output is a lossless encode, which runs on the host.

Usage: decode_and_encode in.(jxl|png|pnm|pgx|pfm|npy) out.(...)
       [--device cuda|cpu] [--host]
"""

from __future__ import annotations

import argparse
import sys

from ..base.device import add_device_args, cli_device


def main(argv=None):
    p = argparse.ArgumentParser(prog="decode_and_encode")
    p.add_argument("input")
    p.add_argument("output")
    add_device_args(p, "a .jxl input's decode")
    args = p.parse_args(argv)
    from ..extras.io import load_image, save_image

    img = load_image(args.input, device=cli_device(args))
    if args.output.lower().endswith(".jxl"):
        from ..api.codestream import encode_lossless

        with open(args.output, "wb") as f:
            f.write(encode_lossless(img))
        return 0
    save_image(args.output, img)
    return 0


if __name__ == "__main__":
    sys.exit(main())
