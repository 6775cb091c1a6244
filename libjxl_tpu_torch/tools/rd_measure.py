"""Rate-distortion matrix vs the reference encoder (docs/RD_CURVE.md).

Usage: python -m libjxl_tpu_torch.tools.rd_measure [image.png ...]
       [--device cuda|cpu] [--host]
With no arguments, sweeps five diverse synthetic images (photo-like,
screenshot/text, smooth gradient, high-noise, line art) x efforts
{3, 5, 7} x distances {0.5, 1, 2, 3}, reporting bytes, butteraugli and
ssimulacra2 for both encoders plus the equal-effort size ratio.
Requires a system libjxl (extras.oracle).

Our encode is the host encode (device=None), as in the reference, so its
bytes do not depend on the device. A .jxl image argument decodes on
--device (the CUDA card by default: a missing card raises; "cpu" runs
the kernels' plain twins) or, under --host, on the host.
"""

import argparse
import sys

import numpy as np

from ..api import codestream
from ..base.device import add_device_args, cli_device
from ..extras import oracle
from ..metrics.distance import butteraugli_distance
from ..metrics.ssimulacra2 import ssimulacra2


def _photo(n=512, seed=2):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    img = (np.stack([(xx * 255 // n), (yy * 255 // n),
                     ((xx + yy) * 255 // (2 * n))], axis=-1)
           + rng.integers(-10, 11, (n, n, 3))
           + (30 * np.sin(xx * 0.05))[..., None])
    return np.clip(img, 0, 255).astype(np.uint8)


def _screenshot(n=512, seed=3):
    rng = np.random.default_rng(seed)
    img = np.full((n, n, 3), 240, dtype=np.float64)
    # text-like strokes: dark 1px runs on a light background
    for _ in range(900):
        y = int(rng.integers(4, n - 4))
        x = int(rng.integers(4, n - 24))
        ln = int(rng.integers(3, 20))
        img[y, x:x + ln] = rng.integers(0, 80)
    # a few UI panels
    for _ in range(6):
        y, x = rng.integers(0, n - 80, 2)
        img[y:y + 70, x:x + 70] = rng.integers(150, 230, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _smooth(n=512, seed=4):
    yy, xx = np.mgrid[0:n, 0:n]
    img = 80 + 100 * (xx + yy) / (2 * n) + 10 * np.sin(xx * 0.004)
    rgb = np.stack([img, img * 0.92 + 8, img * 1.08 - 14], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _noisy(n=512, seed=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    img = (120 + 60 * np.sin(xx * 0.03) + 50 * np.cos(yy * 0.02 + 1)
           + rng.normal(0, 18, (n, n)))
    rgb = np.stack([img, img * 0.92 + 8, img * 1.08 - 14], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _lineart(n=512, seed=6):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    img = 110 + 80 * np.sin(xx * 0.09) * np.cos(yy * 0.07) \
        + rng.normal(0, 4, (n, n))
    rgb = np.stack([img, img * 0.92 + 8, img * 1.08 - 14], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


CORPUS = (("photo", _photo), ("screenshot", _screenshot),
          ("smooth", _smooth), ("noisy", _noisy), ("lineart", _lineart))


def main(argv=None):
    p = argparse.ArgumentParser(prog="rd_measure")
    p.add_argument("images", nargs="*",
                   help="images to sweep (default: the synthetic corpus)")
    add_device_args(p, "a .jxl image's decode")
    args = p.parse_args(argv)
    if not oracle.available():
        print("no system libjxl; cannot compare", file=sys.stderr)
        return 1
    if args.images:
        from ..extras.io import load_image

        device = cli_device(args)
        images = [(p.rsplit("/", 1)[-1],
                   load_image(p, device=device)[:, :, :3])
                  for p in args.images]
    else:
        images = [(name, fn()) for name, fn in CORPUS]
    ratios = []
    print("| image | e | d | ref B | ref BA | ref S2 "
          "| ours B | ours BA | ours S2 | size ratio |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for name, img in images:
        for e in (3, 5, 7):
            for d in (0.5, 1.0, 2.0, 3.0):
                ref = oracle.encode(img, distance=d, effort=e)
                rdec = oracle.decode(ref)[0][:, :, :3]
                ours = codestream.encode_lossy(img, distance=d, effort=e,
                                               device=None)
                odec = oracle.decode(ours)[0][:, :, :3]
                b_ref = butteraugli_distance(img, rdec)
                b_ours = butteraugli_distance(img, odec)
                s_ref = ssimulacra2(img, rdec)
                s_ours = ssimulacra2(img, odec)
                ratio = len(ours) / len(ref)
                ratios.append(ratio)
                print(f"| {name} | {e} | {d} | {len(ref)} | {b_ref:.2f} "
                      f"| {s_ref:.1f} | {len(ours)} | {b_ours:.2f} "
                      f"| {s_ours:.1f} | {ratio:.2f} |", flush=True)
    med = float(np.median(ratios))
    print(f"\nmedian size ratio (ours/ref at equal d, e): {med:.3f} over "
          f"{len(ratios)} cells")
    return 0


if __name__ == "__main__":
    sys.exit(main())
