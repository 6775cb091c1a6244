"""Read Exif metadata from a JXL container and apply the orientation
(examples/decode_exif_metadata.cc analog).

The decode runs on --device (the CUDA card by default: a missing card
raises; "cpu" runs the kernels' plain twins) or, under --host, on the
host.

Usage: python -m libjxl_tpu_torch.examples.decode_exif_metadata image.jxl
       [out.png] [--device cuda|cpu] [--host]
"""

import argparse
import sys

from ..api.codestream import decode
from ..base.device import add_device_args, cli_device
from ..extras.exif import get_exif_orientation, reset_exif_orientation
from ..io.container import extract_codestream, is_container, parse_boxes


def main(argv=None):
    p = argparse.ArgumentParser(prog="decode_exif_metadata")
    p.add_argument("input")
    p.add_argument("output", nargs="?", default=None)
    add_device_args(p, "the decode")
    args = p.parse_args(argv)
    with open(args.input, "rb") as f:
        data = f.read()
    exif = None
    if is_container(data):
        for box_type, payload, _ in parse_boxes(data[12:]):
            if box_type == b"Exif":
                exif = payload[4:]  # skip the 4-byte tiff header offset
        codestream = extract_codestream(data)
    else:
        codestream = data
    if exif is None:
        print("no Exif box present")
    else:
        orient = get_exif_orientation(exif)
        print(f"Exif payload: {len(exif)} bytes, orientation={orient}")
        reset = reset_exif_orientation(exif)
        print(f"orientation after reset: {get_exif_orientation(reset)}")
    image, _meta = decode(codestream, device=cli_device(args))
    print(f"decoded {image.shape[1]}x{image.shape[0]} image")
    if args.output:
        from ..extras.io import save_image

        save_image(args.output, image)
    return 0


if __name__ == "__main__":
    sys.exit(main())
