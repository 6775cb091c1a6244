"""Anchor this package's Butteraugli comparator and distance calibration
against the REFERENCE implementation.

Usage: python -m libjxl_tpu_torch.tools.anchor_butteraugli --out FILE.md
       [--device cuda|cpu] [--host]

The system libjxl exports the reference's Butteraugli through its C API
(extras/oracle.butteraugli; the comparator behind cjxl's quality
feedback loop, butteraugli/butteraugli.h:166-212), so both can be
measured:

1. comparator anchor: our butteraugli_score against the reference's max
   distance on identical (orig, degraded) pairs, the ratio per pair (1.0
   = exact agreement);
2. calibration anchor: for each image x public distance, the
   REFERENCE-Butteraugli score of OUR encoder's decode against that of the
   ORACLE encoder's own decode at the same requested distance; their ratio
   is the externally judged calibration of api/codestream's
   _calibrated_distance.

Writes the measured tables as Markdown to --out (the repository keeps
them in docs/BUTTERAUGLI_ANCHOR.md; this tool writes there only when
--out names it). Our encode and decode run on --device (the CUDA card by
default: a missing card raises; "cpu" runs the torch forms and the
kernels' plain twins) or, under --host, on the host. Needs a system
libjxl: without one it prints why and returns 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..api import codestream
from ..base.device import add_device_args, cli_device
from ..extras import oracle
from ..metrics.butteraugli import butteraugli_score
from ..ops.xyb import srgb_u8_to_linear

COMPARATOR_DISTANCES = (("d1", 1.0), ("d3", 3.0))
CALIBRATION_DISTANCES = (0.5, 1.0, 2.0, 3.0)


def _photo(h=256, w=256, seed=7):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([
        120 + 60 * np.sin(xx * 0.021) + 40 * np.cos(yy * 0.017),
        110 + 55 * np.sin(xx * 0.013 + 1) + 45 * np.cos(yy * 0.026),
        130 + 50 * np.sin((xx + yy) * 0.009) + 30 * np.cos(yy * 0.023),
    ], axis=-1) + rng.normal(0, 7, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _texture(h=256, w=256, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 1, (h // 4, w // 4))
    base = np.repeat(np.repeat(base, 4, 0), 4, 1)
    fine = rng.normal(0, 0.6, (h, w))
    img = 128 + 45 * base + 25 * fine
    return np.clip(np.stack([img, img * 0.95 + 6, img * 1.05 - 8], -1),
                   0, 255).astype(np.uint8)


def _edges(h=256, w=256):
    img = np.full((h, w, 3), 225, np.uint8)
    for k, y in enumerate(range(8, h - 8, 24)):
        img[y:y + 12, 8 + k * 4:w - 8 - k * 3] = (40 + 10 * k, 60, 180)
    img[:, w // 2:] = 255 - img[:, w // 2:]
    return img


def images():
    """The anchored images, (name, u8[H, W, 3])."""
    return [("photo", _photo()), ("texture", _texture()),
            ("edges", _edges())]


def _ours_score(a_u8, b_u8):
    a = np.moveaxis(srgb_u8_to_linear(a_u8), -1, 0)
    b = np.moveaxis(srgb_u8_to_linear(b_u8), -1, 0)
    return butteraugli_score(a, b)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="anchor_butteraugli")
    p.add_argument("--out", required=True,
                   help="the Markdown file to write "
                        "(docs/BUTTERAUGLI_ANCHOR.md for the repository's)")
    add_device_args(p, "our encode and decode")
    args = p.parse_args(argv)
    if not oracle.available():
        print("no system libjxl", file=sys.stderr)
        return 1
    device = cli_device(args)
    imgs = images()
    lines = [
        "# Butteraugli anchoring vs the reference implementation", "",
        "Generated by libjxl_tpu_torch/tools/anchor_butteraugli.py against "
        "the system libjxl %d.%d.%d" % oracle.version(),
        "(the reference's own comparator via JxlButteraugliCompute).",
        "", "## 1. Comparator agreement", "",
        "Same (orig, degraded) pair scored by both comparators "
        "(max-norm):", "",
        "| image | pair | ref BA | our BA | ours/ref |",
        "|---|---|---|---|---|"]
    ratios = []
    for name, img in imgs:
        for tag, dist in COMPARATOR_DISTANCES:
            enc = oracle.encode(img, distance=dist, effort=5)
            dec = oracle.decode(enc)[0][:, :, :3]
            ref_mx, _ = oracle.butteraugli(img, dec)
            ours = _ours_score(img, dec)
            r = ours / ref_mx if ref_mx else float("nan")
            ratios.append(r)
            lines.append(f"| {name} | oracle-{tag} decode | {ref_mx:.4f}"
                         f" | {ours:.4f} | {r:.3f} |")
            print(lines[-1])
    lines += [
        "",
        f"Median ours/ref ratio: **{np.median(ratios):.3f}** "
        f"(range {min(ratios):.3f}-{max(ratios):.3f}).",
        "", "## 2. Distance-calibration anchor", "",
        "REFERENCE-Butteraugli score of each encoder's decode at the "
        "same requested public distance (the externally-judged "
        "calibration; 'ours/oracle' ~ 1.0 means our distance parameter "
        "delivers reference-equivalent quality):", "",
        "| image | d | ref BA of OUR decode | ref BA of ORACLE decode "
        "| ours/oracle |", "|---|---|---|---|---|"]
    cal = []
    for name, img in imgs:
        for dist in CALIBRATION_DISTANCES:
            ours_enc = codestream.encode_lossy(img, distance=dist,
                                               effort=5, device=device)
            ours_dec = codestream.decode(ours_enc, device=device)[0][
                :, :, :3]
            ref_enc = oracle.encode(img, distance=dist, effort=5)
            ref_dec = oracle.decode(ref_enc)[0][:, :, :3]
            ba_ours, _ = oracle.butteraugli(img, ours_dec)
            ba_ref, _ = oracle.butteraugli(img, ref_dec)
            r = ba_ours / ba_ref if ba_ref else float("nan")
            cal.append(r)
            lines.append(f"| {name} | {dist} | {ba_ours:.4f} | "
                         f"{ba_ref:.4f} | {r:.3f} |")
            print(lines[-1])
    lines += [
        "",
        f"Median ours/oracle delivered-distance ratio: "
        f"**{np.median(cal):.3f}**.",
        "",
        "Interpretation: the 0.7x internal calibration "
        "(api/codestream.py `_calibrated_distance`) is validated here "
        "by the REFERENCE comparator, not by this package's own — a "
        "ratio near 1.0 means a user asking for `-d N` gets the same "
        "reference-judged perceptual error they would get from cjxl "
        "at `-d N`.", ""]
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
