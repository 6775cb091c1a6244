"""icc_simplify CLI (tools/icc_simplify.cc analog): read an ICC
profile (.icc) or an image with an embedded profile, print the
detected enum color description, and optionally strip the profile
from a PNG when it matches sRGB (the simplification).

An image input in .jxl decodes on --device (the CUDA card by default: a
missing card raises; "cpu" runs the kernels' plain twins) or, under
--host, on the host."""

from __future__ import annotations

import argparse
import pathlib
import sys

from ..base.device import add_device_args, cli_device


def main(argv=None):
    p = argparse.ArgumentParser(prog="icc_simplify")
    p.add_argument("input", help=".icc profile or image with one")
    p.add_argument("output", nargs="?", default=None,
                   help="optional: rewrite image without the profile "
                        "when it simplifies to sRGB")
    add_device_args(p, "a .jxl input's decode")
    args = p.parse_args(argv)
    device = cli_device(args)
    from ..io.icc_analyze import analyze_icc

    path = pathlib.Path(args.input)
    if path.suffix.lower() in (".icc", ".icm"):
        icc = path.read_bytes()
    else:
        from ..extras.io import load_image

        _img, icc = load_image(path, return_icc=True, device=device)
        if icc is None:
            print("no embedded ICC profile", file=sys.stderr)
            return 1
    info = analyze_icc(icc)
    print(info["description"])
    if args.output:
        if info["description"] == "RGB_D65_SRG_Rel_SRG":
            from ..extras.io import load_image, save_image

            img, _ = load_image(path, return_icc=True, device=device)
            save_image(args.output, img)  # no icc: sRGB is the default
            print(f"simplified to untagged sRGB: {args.output}",
                  file=sys.stderr)
        else:
            print("profile does not simplify to sRGB; not rewritten",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
