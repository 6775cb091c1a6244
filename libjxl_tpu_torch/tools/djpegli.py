"""djpegli — float-precision JPEG decoder CLI (tools/djpegli.cc analog)."""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="djpegli", description="jpegli JPEG decoder")
    p.add_argument("input", help="input .jpg file")
    p.add_argument("output", help="output image (png/pnm/npy)")
    p.add_argument("--bitdepth", type=int, default=8, choices=(8, 16),
                   help="output bit depth (float pipeline quantizes "
                        "only at the end; 16 keeps the extra precision)")
    p.add_argument("--num_reps", type=int, default=1,
                   help="decode N times (benchmarking)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None):
    try:
        return _main(argv)
    except Exception as e:
        from ..base.status import JXLError

        if isinstance(e, (JXLError, OSError)):
            print(f"djpegli: error: {e}", file=sys.stderr)
            return 1
        raise


def _main(argv):
    args = build_parser().parse_args(argv)
    from ..extras.io import save_image
    from ..jpegli import decode_jpegli

    from ..extras.mmapio import read_mapped

    data = read_mapped(args.input)
    t0 = time.time()
    for _ in range(max(1, args.num_reps)):
        img = decode_jpegli(data, bitdepth=args.bitdepth)
    dt = (time.time() - t0) / max(1, args.num_reps)
    if img.shape[2] == 1:
        img = img[:, :, 0]
    save_image(args.output, img)
    if args.verbose:
        mp = img.shape[0] * img.shape[1] / 1e6
        print(f"djpegli: {img.shape[1]}x{img.shape[0]}, {dt:.3f} s "
              f"({mp / dt:.2f} MP/s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
