"""Conformance runner: decode .jxl files to .npy and compare against
reference arrays with per-frame RMSE and peak-error bounds.

Mirrors tools/conformance/conformance.py (ISO/IEC 18181-3 style): the
test corpus directory holds, per case, `input.jxl`, `ref.npy`
(float32, frames x H x W x C, decoded pixels in [0, 1]) and `test.json`
with `rmse_limit` / `peak_error` bounds. `generate` builds a corpus from
images using this encoder (regression corpus); `check` validates a
decoder run against the stored references.

Both take --device (the CUDA card by default: a missing card raises;
"cpu" runs the kernels' plain twins) or --host (device=None): the decode
of every case, the load of a .jxl image and the lossy encode run there.
The lossless encode runs on the host, as in the reference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..base.device import add_device_args, cli_device


def decode_to_array(path: str, device="cuda") -> np.ndarray:
    """Decode a .jxl file -> float32 (frames, H, W, C) in [0, 1] on
    `device` (api.codestream.decode_frames' device)."""
    from ..api.codestream import decode_frames
    from ..io.container import extract_codestream, is_container

    with open(path, "rb") as f:
        data = f.read()
    if is_container(data):
        data = extract_codestream(data)
    frames = []
    for img, _dur in decode_frames(data, device=device):
        a = np.asarray(img)
        if a.ndim == 2:
            a = a[:, :, None]
        if a.dtype == np.uint8:
            a = a.astype(np.float32) / 255.0
        elif a.dtype == np.uint16:
            a = a.astype(np.float32) / 65535.0
        else:
            a = a.astype(np.float32)
        frames.append(a)
    return np.stack(frames)


def check_case(case_dir: str, verbose: bool = False,
               device="cuda") -> list:
    """-> list of failure strings (empty = pass); decodes on `device`."""
    with open(os.path.join(case_dir, "test.json")) as f:
        spec = json.load(f)
    ref = np.load(os.path.join(case_dir, "ref.npy"))
    out = decode_to_array(os.path.join(case_dir, "input.jxl"), device)
    failures = []
    if out.shape != ref.shape:
        return [f"shape mismatch: {out.shape} vs {ref.shape}"]
    rmse_limit = spec.get("rmse_limit", 0.004)
    peak_limit = spec.get("peak_error", 0.02)
    for i, (o, r) in enumerate(zip(out, ref)):
        diff = o.astype(np.float64) - r.astype(np.float64)
        rmse = float(np.sqrt((diff * diff).mean()))
        peak = float(np.abs(diff).max())
        if verbose:
            print(f"  frame {i}: rmse={rmse:.6f} peak={peak:.6f}")
        if rmse > rmse_limit:
            failures.append(f"frame {i}: rmse {rmse:.6f} > {rmse_limit}")
        if peak > peak_limit:
            failures.append(f"frame {i}: peak {peak:.6f} > {peak_limit}")
    return failures


def generate_case(image: np.ndarray, case_dir: str, lossless: bool = False,
                  distance: float = 1.0, rmse_limit: float = None,
                  peak_limit: float = None, effort: int = 5,
                  device="cuda") -> None:
    """Encode `image`, decode it back, store stream + reference + bounds.

    A lossy encode (at `effort`) and the decode run on `device`; a
    lossless encode runs on the host."""
    from ..api.codestream import encode_lossless, encode_lossy

    os.makedirs(case_dir, exist_ok=True)
    data = encode_lossless(image) if lossless \
        else encode_lossy(image, distance=distance, effort=effort,
                          device=device)
    with open(os.path.join(case_dir, "input.jxl"), "wb") as f:
        f.write(data)
    ref = decode_to_array(os.path.join(case_dir, "input.jxl"), device)
    np.save(os.path.join(case_dir, "ref.npy"), ref)
    if rmse_limit is None:
        rmse_limit = 1e-6 if lossless else 0.004
    if peak_limit is None:
        peak_limit = 1e-6 if lossless else 0.02
    with open(os.path.join(case_dir, "test.json"), "w") as f:
        json.dump({"rmse_limit": rmse_limit, "peak_error": peak_limit}, f)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="JPEG XL conformance runner (18181-3 style)")
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate", help="build a corpus from images")
    g.add_argument("images", nargs="+")
    g.add_argument("--out", required=True)
    g.add_argument("--lossless", action="store_true")
    g.add_argument("-d", "--distance", type=float, default=1.0)
    g.add_argument("-e", "--effort", type=int, default=5)
    add_device_args(g, "the encode and the decode")
    c = sub.add_parser("check", help="validate corpus cases")
    c.add_argument("corpus", help="corpus dir (one sub-dir per case)")
    c.add_argument("-v", "--verbose", action="store_true")
    add_device_args(c, "the decode")
    args = p.parse_args(argv)
    device = cli_device(args)

    if args.cmd == "generate":
        from ..extras.io import load_image

        for path in args.images:
            name = os.path.splitext(os.path.basename(path))[0]
            img = load_image(path, device=device)
            generate_case(img, os.path.join(args.out, name),
                          lossless=args.lossless, distance=args.distance,
                          effort=args.effort, device=device)
            print(f"generated {name}")
        return 0

    cases = sorted(d for d in os.listdir(args.corpus)
                   if os.path.isdir(os.path.join(args.corpus, d)))
    num_fail = 0
    for case in cases:
        failures = check_case(os.path.join(args.corpus, case), args.verbose,
                              device)
        status = "OK" if not failures else "FAIL"
        print(f"{case}: {status}")
        for msg in failures:
            print(f"  {msg}")
        num_fail += bool(failures)
    print(f"{len(cases) - num_fail}/{len(cases)} cases pass")
    return 1 if num_fail else 0


if __name__ == "__main__":
    sys.exit(main())
