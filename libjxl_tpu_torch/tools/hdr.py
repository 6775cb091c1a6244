"""HDR utility CLI (tools/hdr/{tone_map,pq_to_hlg,display_to_hlg,
render_hlg}.cc analogs).

Subcommands operate on float images (PFM/NPY, linear Rec.2020 unless
noted) or uint8/16 PNG:
  tone_map        Rec.2408 tone mapping from source peak to target peak
  pq_to_hlg       PQ-encoded input -> HLG-encoded output
  hlg_to_pq       HLG-encoded input -> PQ-encoded output
  render_hlg      apply the HLG OOTF for a given display peak
A .jxl input decodes on --device (the CUDA card by default: a missing
card raises; "cpu" runs the kernels' plain twins) or, under --host, on
the host; the transfer functions are host NumPy.

Usage: python -m libjxl_tpu_torch.tools.hdr <subcommand> in out [options]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..base.device import add_device_args, cli_device


def _load_float(path, device="cuda"):
    from ..extras.io import load_image

    img = load_image(path, device=device)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def _save_float(path, img):
    from ..extras.io import save_image

    if path.lower().endswith((".pfm", ".npy")):
        save_image(path, img.astype(np.float32))
    else:
        save_image(path, np.clip(img * 255.0 + 0.5, 0,
                                 255).astype(np.uint8))


def main(argv=None):
    p = argparse.ArgumentParser(prog="jxl_hdr")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("tone_map", "pq_to_hlg", "hlg_to_pq", "render_hlg"):
        sp = sub.add_parser(name)
        sp.add_argument("input")
        sp.add_argument("output")
        if name == "tone_map":
            sp.add_argument("--source_nits", type=float, default=10000.0)
            sp.add_argument("--target_nits", type=float, default=300.0)
        if name in ("pq_to_hlg", "render_hlg"):
            sp.add_argument("--max_nits", type=float, default=1000.0,
                            help="peak display luminance")
        add_device_args(sp, "a .jxl input's decode")
    args = p.parse_args(argv)
    from ..render.tone_map import (
        hlg_inv_oetf,
        hlg_oetf,
        hlg_ootf,
        pq_eotf,
        pq_inv_eotf,
        rec2408_tone_map,
    )

    img = _load_float(args.input, cli_device(args))
    chw = np.moveaxis(img[:, :, :3], -1, 0)
    if args.cmd == "tone_map":
        # input: PQ-encoded; tone map in linear nits, re-encode to PQ
        nits = pq_eotf(chw)
        rel = nits / args.source_nits  # 1.0 == source peak
        mapped = rec2408_tone_map(rel, args.source_nits,
                                  args.target_nits)  # 1.0 == target peak
        out = pq_inv_eotf(np.clip(mapped, 0, None) * args.target_nits)
    elif args.cmd == "pq_to_hlg":
        # PQ -> linear nits -> inverse OOTF at peak -> HLG OETF
        nits = pq_eotf(chw)
        scene = np.clip(nits / args.max_nits, 0.0, 1.0)
        # inverse OOTF: scene = display^(1/gamma) per luminance weighting
        # (hlg.cc InverseOOTF approximated by per-pixel luminance gamma)
        lum = (0.2627 * scene[0] + 0.6780 * scene[1] + 0.0593 * scene[2])
        gamma = 1.2 + 0.42 * np.log10(args.max_nits / 1000.0)
        safe = np.where(lum > 1e-6, lum, 1.0)
        scale = np.where(lum > 1e-6, safe ** (1.0 / gamma - 1.0), 0.0)
        out = hlg_oetf(np.clip(scene * scale, 0.0, 1.0))
    elif args.cmd == "hlg_to_pq":
        scene = hlg_inv_oetf(np.clip(chw, 0.0, 1.0))
        display = hlg_ootf(scene, 1000.0)
        out = pq_inv_eotf(np.clip(display, 0.0, 1.0) * 1000.0)
    else:  # render_hlg
        scene = hlg_inv_oetf(np.clip(chw, 0.0, 1.0))
        display = hlg_ootf(scene, args.max_nits)
        out = display ** (1.0 / 2.2)  # display-referred SDR-ish output
    _save_float(args.output, np.moveaxis(out, 0, -1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
