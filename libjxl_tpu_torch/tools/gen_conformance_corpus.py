"""Generate an oracle conformance corpus.

Usage: python -m libjxl_tpu_torch.tools.gen_conformance_corpus --out DIR
       [--device cuda|cpu] [--host]

Encodes a matrix of deterministic test images with the REFERENCE
implementation (system libjxl via extras/oracle.py) and stores, per case,
under DIR:

  <name>.jxl  - the oracle-encoded stream (reference bitstream)
  <name>.npy  - the oracle decoder's own pixels for that stream
                (the conformance ground truth)

plus manifest.json recording per-case metadata and the error this
package's decoder measured at generation time, and one JPEG
reconstruction pair (jpeg_recon.jpg / .jxl) where PIL is present. The
repository's checked-in corpus is tests/data/conformance/ (replayed by
tests/test_conformance_oracle.py); this tool writes there only when DIR
names it. Our decode of each case runs on --device (the CUDA card by
default: a missing card raises; "cpu" runs the kernels' plain twins) or,
under --host, on the host. Needs a system libjxl: without one it prints
why and returns 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..api import codestream
from ..base.device import add_device_args, cli_device
from ..extras import oracle


def _photo(h=96, w=128, seed=7):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([
        120 + 60 * np.sin(xx * 0.05) + 40 * np.cos(yy * 0.04),
        110 + 55 * np.sin(xx * 0.03 + 1) + 45 * np.cos(yy * 0.06),
        130 + 50 * np.sin((xx + yy) * 0.02) + 30 * np.cos(yy * 0.05),
    ], axis=-1) + rng.normal(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _flat(h=96, w=128):
    """Screenshot-like: few colors, hard edges, repeated glyph blocks."""
    img = np.full((h, w, 3), 240, np.uint8)
    img[::12] = (30, 30, 30)
    glyph = np.zeros((8, 6), bool)
    glyph[1:7, 1] = glyph[1, 1:5] = glyph[4, 1:4] = True
    for by in range(2, h - 10, 16):
        for bx in range(4, w - 8, 10):
            img[by:by + 8, bx:bx + 6][glyph] = (20, 40, 160)
    img[h // 2:, : w // 3] = (200, 60, 60)
    return img


def _gray(h=80, w=96, seed=3):
    return _photo(h, w, seed)[:, :, 1]


def _rgba(seed=9):
    img = _photo(seed=seed)
    a = np.linspace(0, 255, img.shape[0] * img.shape[1]).reshape(
        img.shape[:2]).astype(np.uint8)
    return np.dstack([img, a])


def _hi16smooth(h=96, w=128, seed=3):
    rng = np.random.default_rng(seed)
    base = (30000 + 9000 * np.sin(np.arange(h)[:, None] * 0.05)
            + rng.normal(0, 800, (h, w)))
    return np.clip(np.stack([base, base * 0.95, base * 1.04], -1),
                   0, 65535).astype(np.uint16)


def _hi16(h=64, w=80, seed=5):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 65536, (h, w, 3), dtype=np.uint16)
    img[: h // 2] = (img[: h // 2] // 257) * 257  # smooth-ish top half
    return img


CASES = [
    # name, image fn, oracle encode kwargs, decode pixel_type
    ("lossless_photo_e1", _photo, dict(lossless=True, effort=1), "uint8"),
    ("lossless_photo_e3", _photo, dict(lossless=True, effort=3), "uint8"),
    ("lossless_photo_e7", _photo, dict(lossless=True, effort=7), "uint8"),
    ("lossless_photo_e9", _photo, dict(lossless=True, effort=9), "uint8"),
    ("lossless_flat_e7", _flat, dict(lossless=True, effort=7), "uint8"),
    ("lossless_gray_e7", _gray, dict(lossless=True, effort=7), "uint8"),
    ("lossless_rgba_e7", _rgba, dict(lossless=True, effort=7), "uint8"),
    ("lossless_hi16_e7", _hi16, dict(lossless=True, effort=7), "uint16"),
    ("lossy_photo_d0.5_e5", _photo, dict(distance=0.5, effort=5), "uint8"),
    ("lossy_photo_d1_e1", _photo, dict(distance=1.0, effort=1), "uint8"),
    ("lossy_photo_d1_e3", _photo, dict(distance=1.0, effort=3), "uint8"),
    ("lossy_photo_d1_e5", _photo, dict(distance=1.0, effort=5), "uint8"),
    ("lossy_photo_d1_e7", _photo, dict(distance=1.0, effort=7), "uint8"),
    ("lossy_photo_d1_e9", _photo, dict(distance=1.0, effort=9), "uint8"),
    ("lossy_photo_d4_e7", _photo, dict(distance=4.0, effort=7), "uint8"),
    ("lossy_flat_d1_e7", _flat, dict(distance=1.0, effort=7), "uint8"),
    ("lossy_gray_d1_e7", _gray, dict(distance=1.0, effort=7), "uint8"),
    ("lossy_rgba_d1_e7", _rgba, dict(distance=1.0, effort=7), "uint8"),
    ("lossy_noise_d1_e5", _photo,
     dict(distance=1.0, effort=5, photon_noise_iso=1600.0), "uint8"),
    ("lossy_modular_d1_e5", _photo,
     dict(distance=1.0, effort=5, modular=True), "uint8"),
    ("lossy_hi16_d1_e5", _hi16smooth,
     dict(distance=1.0, effort=5), "uint16"),
    # high distance: the reference emits a MODULAR-coded 1:8 kLFFrame
    # (progressive DC) that the consuming frame reads via kUseDcFrame
    ("lossy_photo_d6_e6", _photo,
     dict(distance=6.0, effort=6), "uint8"),
]


def _jpeg_case(out: str, manifest: dict) -> None:
    """The JPEG reconstruction case: the oracle recompresses a JPEG and
    our decoder must give the original JPEG bytes back. Needs PIL."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_photo(seed=21)).save(buf, format="JPEG", quality=88)
    jpg = buf.getvalue()
    data = oracle.encode_jpeg(jpg)
    with open(os.path.join(out, "jpeg_recon.jxl"), "wb") as f:
        f.write(data)
    with open(os.path.join(out, "jpeg_recon.jpg"), "wb") as f:
        f.write(jpg)
    manifest["cases"].append({
        "name": "jpeg_recon", "kind": "jpeg_reconstruction",
        "stream_bytes": len(data), "jpeg_bytes": len(jpg)})
    print(f"jpeg_recon: {len(data)}B for {len(jpg)}B jpeg")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gen_conformance_corpus")
    p.add_argument("--out", required=True,
                   help="the corpus directory (tests/data/conformance to "
                        "regenerate the checked-in corpus)")
    add_device_args(p, "our decode of each case")
    args = p.parse_args(argv)
    if not oracle.available():
        print("no system libjxl — cannot generate the corpus",
              file=sys.stderr)
        return 1
    device = cli_device(args)
    os.makedirs(args.out, exist_ok=True)
    manifest = {"oracle_version": list(oracle.version()), "cases": []}
    for name, make, kw, ptype in CASES:
        img = make()
        data = oracle.encode(img, **kw)
        ref, _ = oracle.decode(data, pixel_type=ptype)
        with open(os.path.join(args.out, name + ".jxl"), "wb") as f:
            f.write(data)
        np.save(os.path.join(args.out, name + ".npy"), ref)
        # our decoder's deviation at generation time, for the manifest
        # (the corpus test holds it to fixed conformance bounds)
        ours, _ = codestream.decode(data, device=device)
        nc = min(ours.shape[2], ref.shape[2])
        d = (ours[:, :, :nc].astype(np.float64)
             - ref[:, :, :nc].astype(np.float64))
        rmse = float(np.sqrt((d ** 2).mean()))
        peak = int(np.abs(d).max())
        manifest["cases"].append({
            "name": name, "kind": "lossless" if kw.get("lossless")
            else "lossy", "pixel_type": ptype,
            "encode_args": dict(kw),
            "shape": list(ref.shape), "stream_bytes": len(data),
            "gen_rmse": round(rmse, 4), "gen_peak": peak,
        })
        print(f"{name}: {len(data)}B rmse={rmse:.4f} peak={peak}")
    try:
        _jpeg_case(args.out, manifest)
    except ImportError as e:  # PIL missing: leave this one case out, loudly
        print(f"jpeg_recon skipped: {e}", file=sys.stderr)
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"wrote {len(manifest['cases'])} cases to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
