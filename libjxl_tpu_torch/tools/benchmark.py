"""benchmark_xl analog: multi-config encode/decode benchmark harness.

Reports BPP, encode/decode MP/s, PSNR, perceptual distance per config
(tools/benchmark/benchmark_stats.cc:132-140 column set).

Usage: python -m libjxl_tpu_torch.tools.benchmark IMAGE... [--codec ...]

The JPEG XL rows encode and decode on --device (the CUDA card by default:
a missing card raises; "cpu" runs the kernels' plain twins); --host runs
them on the host. The png/jpeg/webp rows need PIL.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _other_codec(image, codec: str, quality: int):
    """PNG/JPEG/WebP comparison rows (tools/benchmark codec plugins)."""
    import io as sio

    from PIL import Image

    fmt = {"png": "PNG", "jpeg": "JPEG", "webp": "WEBP"}[codec]
    buf = sio.BytesIO()
    im = Image.fromarray(image)
    t0 = time.perf_counter()
    if codec == "png":
        im.save(buf, fmt)
    else:
        im.save(buf, fmt, quality=quality)
    enc_t = time.perf_counter() - t0
    data = buf.getvalue()
    t0 = time.perf_counter()
    out = np.asarray(Image.open(sio.BytesIO(data)).convert(
        "RGB" if image.shape[-1] == 3 else "L"))
    dec_t = time.perf_counter() - t0
    return data, out.reshape(image.shape), enc_t, dec_t


def run_config(image, config: str, device="cuda"):
    from ..api.codestream import decode, encode_lossless, encode_lossy
    from ..metrics import (
        butteraugli_distance,
        compute_psnr,
        msssim_xyb,
        ssimulacra2,
    )

    h, w = image.shape[:2]
    mp = h * w / 1e6
    parts = config.split(":")
    if parts[0] in ("png", "jpeg", "webp"):
        quality = int(parts[1][1:]) if len(parts) > 1 else 85
        data, out, enc_t, dec_t = _other_codec(image, parts[0], quality)
    elif parts[0] == "jpegli":
        # jpegli:d1.0[:p2][:420] — the sibling codec as a benchmark row
        from ..jpegli import decode_jpegli, encode_jpegli

        distance, level, ss = 1.0, 0, "444"
        for p in parts[1:]:
            if p.startswith("d"):
                distance = float(p[1:])
            elif p.startswith("p"):
                level = int(p[1:])
            elif p in ("420", "444"):
                ss = p
        t0 = time.perf_counter()
        data = encode_jpegli(image, distance=distance, progressive=level,
                             subsampling=ss)
        enc_t = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = decode_jpegli(data)
        dec_t = time.perf_counter() - t0
        if out.shape[-1] == 1 and image.ndim == 2:
            out = out[:, :, 0]
    elif parts[0] == "m" or parts[0] == "lossless":
        t0 = time.perf_counter()
        data = encode_lossless(image)
        enc_t = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, _ = decode(data, device=device)
        dec_t = time.perf_counter() - t0
    else:
        distance = float(parts[0][1:]) if parts[0].startswith("d") else 1.0
        t0 = time.perf_counter()
        data = encode_lossy(image, distance=distance, device=device)
        enc_t = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, _ = decode(data, device=device)
        dec_t = time.perf_counter() - t0
    res = {
        "config": config,
        "bpp": round(len(data) * 8 / (h * w), 4),
        "enc_mps": round(mp / enc_t, 4),
        "dec_mps": round(mp / dec_t, 4),
        # lossless roundtrips report +inf PSNR; keep the JSON strict
        "psnr": (lambda p: round(p, 2) if np.isfinite(p) else None)(
            compute_psnr(image, out.reshape(image.shape))),
    }
    if image.shape[-1] == 3 and image.dtype == np.uint8:
        ba = butteraugli_distance(image, out.reshape(image.shape))
        res["butteraugli"] = round(ba, 3)
        # QABPP = bpp * max butteraugli (benchmark_stats.cc:132-140)
        res["qabpp"] = round(res["bpp"] * max(ba, 1e-9), 4)
        if image.shape[0] >= 8 and image.shape[1] >= 8:
            # BPP * 3-norm of the diffmap (ComputeDistanceP analog)
            from ..metrics.butteraugli import butteraugli_diffmap
            from ..ops.xyb import srgb_to_linear

            la = np.moveaxis(srgb_to_linear(
                image.astype(np.float64) / 255.0), -1, 0)
            lb = np.moveaxis(srgb_to_linear(
                out.reshape(image.shape).astype(np.float64) / 255.0), -1, 0)
            dm = butteraugli_diffmap(la, lb)
            res["pnorm"] = round(float(np.mean(dm ** 3) ** (1 / 3)), 4)
        res["msssim"] = round(msssim_xyb(image, out.reshape(image.shape)), 2)
        if image.shape[0] >= 8 and image.shape[1] >= 8:
            res["ssimulacra2"] = round(
                ssimulacra2(image, out.reshape(image.shape)), 2)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmark_xl")
    p.add_argument("inputs", nargs="+", help="input images")
    p.add_argument("--codec", default="d1.0,d4.0,m",
                   help="comma-separated configs: dN (vardct), m (modular)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the JPEG XL rows: cuda (the "
                        "default; raises without a card) or cpu (the "
                        "kernels' plain twins)")
    p.add_argument("--host", action="store_true",
                   help="encode and decode the JPEG XL rows on the host")
    args = p.parse_args(argv)
    device = None if args.host else args.device
    from ..extras.io import load_image

    for path in args.inputs:
        image = load_image(path, device=device)
        for config in args.codec.split(","):
            res = run_config(image, config, device)
            res["input"] = path
            print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
