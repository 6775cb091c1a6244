"""Progressive decode example (examples/decode_progressive.cc analog):
decodes each pass of a progressive stream into its own image.

Host code, as in the reference: each pass decodes through the host
vardct.frame with the AC decode cut after that pass, and no device stage.

Usage: python -m libjxl_tpu_torch.examples.decode_progressive in.jxl
       out_prefix
"""

import argparse
import sys

import numpy as np

from ..api.codestream import parse_codestream_header
from ..extras.io import save_image
from ..io.bits import BitReader
from ..io.container import extract_codestream
from ..io.frame_header import FrameHeader
from ..ops.xyb import linear_to_srgb
from ..vardct import frame as vf


def main(argv=None):
    p = argparse.ArgumentParser(prog="decode_progressive")
    p.add_argument("input")
    p.add_argument("out_prefix")
    args = p.parse_args(argv)
    with open(args.input, "rb") as f:
        data = extract_codestream(f.read())
    # decode pass-by-pass by truncating the AC group decode at each pass
    r = BitReader(data)
    meta = parse_codestream_header(r)
    fh = FrameHeader(meta)
    fh.read(r)
    num_passes = fh.passes.num_passes
    for upto in range(1, num_passes + 1):
        rr = BitReader(data)
        parse_codestream_header(rr)
        fh2 = FrameHeader(meta)
        fh2.read(rr)
        orig = vf.decode_ac_group

        def limited(sr, state, g, p=0):
            if p < upto:
                orig(sr, state, g, p)

        vf.decode_ac_group = limited
        try:
            chans = vf.decode_vardct_frame(rr, fh2)
        finally:
            vf.decode_ac_group = orig
        srgb = linear_to_srgb(np.stack(chans, axis=-1))
        img = np.clip(np.round(srgb * 255.0), 0, 255).astype(np.uint8)
        path = f"{args.out_prefix}_pass{upto}.png"
        save_image(path, img)
        print(f"pass {upto}/{num_passes} -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
