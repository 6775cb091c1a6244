"""cjxl — JPEG XL encoder CLI (tools/cjxl_main.cc analog).

Usage: python -m libjxl_tpu_torch.tools.cjxl INPUT OUTPUT.jxl [options]

A lossy encode's device stages run on --device (the CUDA card by default:
a missing card raises where a stage needs it; "cpu" runs the torch forms
with the kernels' plain twins); --host encodes on the host (no route for
--streaming). Lossless encodes and JPEG recompression run on the host.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="cjxl", description="JPEG XL encoder (PyTorch/CUDA)")
    p.add_argument("input", help="input image (png/pnm/npy/...)")
    p.add_argument("output", help="output .jxl file")
    p.add_argument("-d", "--distance", type=float, default=1.0,
                   help="max butteraugli distance (0 = lossless); default 1.0")
    p.add_argument("-q", "--quality", type=float, default=None,
                   help="quality 0-100 (100 = lossless); maps onto distance")
    p.add_argument("-e", "--effort", type=int, default=3,
                   help="encode effort 1-10 (round-1: affects modular tree "
                        "and quant choices)")
    p.add_argument("-m", "--modular", type=int, choices=(0, 1), default=None,
                   help="force modular (1) or VarDCT (0) mode")
    p.add_argument("--container", action="store_true",
                   help="wrap the codestream in an ISOBMFF container")
    p.add_argument("--group-size-shift", type=int, default=1, choices=range(4))
    p.add_argument("--lossless_jpeg", type=int, default=1,
                   help="1 (default): JPEG input is recompressed losslessly "
                        "(bit-exact reconstruction); 0: re-encode pixels")
    p.add_argument("-p", "--progressive", type=int, default=1,
                   metavar="PASSES", help="number of progressive passes")
    p.add_argument("--resampling", type=int, default=1, choices=(1, 2, 4, 8),
                   help="downsample before encoding; decoder upsamples")
    p.add_argument("--photon_noise_iso", type=float, default=None,
                   help="add synthetic photon noise for this ISO")
    p.add_argument("--preview", type=int, default=None, metavar="PX",
                   help="embed a preview frame (long side <= PX)")
    p.add_argument("--responsive", type=int, choices=(0, 1), default=0,
                   help="modular Squeeze pyramid (progressive lossless)")
    p.add_argument("--streaming", action="store_true",
                   help="DC-group streaming encoder (bounded memory)")
    p.add_argument("--hosts", type=int, default=1,
                   help="parallel hosts for --streaming (demo: threads)")
    p.add_argument("--compress_boxes", type=int, choices=(0, 1), default=1,
                   help="Brotli-compress metadata boxes in the container")
    p.add_argument("--num_threads", type=int, default=0,
                   help="accepted for cjxl compatibility (device "
                        "parallelism is mesh-sharding based)")
    p.add_argument("--jpeg_transcode", choices=("vardct", "tokens"),
                   default="vardct",
                   help="JPEG recompression layout: real VarDCT frame "
                        "(default) or the legacy token model")
    p.add_argument("--epf", type=int, default=None, choices=range(-1, 4),
                   help="edge-preserving filter level (-1 = encoder "
                        "default, 0 = off)")
    p.add_argument("--gaborish", type=int, choices=(0, 1), default=None,
                   help="force Gaborish on/off")
    p.add_argument("--dots", type=int, choices=(0, 1), default=None,
                   help="force dot detection on/off")
    p.add_argument("--patches", type=int, choices=(0, 1), default=None,
                   help="force patch detection on/off")
    p.add_argument("--noise", type=int, choices=(0, 1), default=None,
                   help="content-adaptive noise synthesis")
    p.add_argument("--progressive_ac", action="store_true",
                   help="spectral-progression AC passes (= -p 2)")
    p.add_argument("--intensity_target", type=float, default=None,
                   help="display nits the stream targets (tone mapping "
                        "metadata; drives the decoder's Rec.2408 stage)")
    p.add_argument("--iterations", type=int, default=None,
                   help="Butteraugli quant-refinement rounds override "
                        "(default: effort tier, <=4 at e7+)")
    p.add_argument("--already_downsampled", action="store_true",
                   help="input is already the low-res frame for "
                        "--resampling N; only signal the upsampling")
    p.add_argument("--alpha_distance", type=float, default=0.0,
                   help="alpha channel distance (only 0 = lossless "
                        "alpha is supported; nonzero warns)")
    p.add_argument("--override_bitdepth", type=int, default=None,
                   help="signal this bit depth instead of the input's "
                        "(modular/lossless)")
    p.add_argument("--codestream_level", type=int, choices=(5, 10),
                   default=5, help="container jxll level box")
    p.add_argument("--exif", default=None, metavar="FILE",
                   help="embed EXIF blob as a container box")
    p.add_argument("--xmp", default=None, metavar="FILE",
                   help="embed XMP/XML blob as a container box")
    p.add_argument("--modular_predictor", type=int, default=None,
                   help="modular predictor 0-15 (15 = per-channel best)")
    p.add_argument("--modular_palette_colors", type=int, default=None,
                   help="max palette size (0 disables palette)")
    p.add_argument("--modular_colorspace", type=int, default=None,
                   help="RCT 0-41 (0 = none, default YCoCg family)")
    p.add_argument("--modular_lossy_palette", type=int, choices=(0, 1),
                   default=None, help="lossy delta palette")
    p.add_argument("--modular_group_size", type=int, choices=range(4),
                   default=None,
                   help="modular group size shift 0-3 (alias of "
                        "--group-size-shift)")
    p.add_argument("--allow_expert_options", action="store_true",
                   help="allow distance > 25 and other extremes")
    p.add_argument("--num_reps", type=int, default=1,
                   help="encode N times (benchmarking)")
    p.add_argument("--disable_output", action="store_true",
                   help="skip writing the output file")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--version", action="store_true",
                   help=argparse.SUPPRESS)
    # accepted for cjxl command-line compatibility; not yet wired to a
    # distinct behavior here (logged when verbose, like the reference
    # ignores settings outside the active tier)
    p.add_argument("--progressive_dc", type=int, choices=(0, 1),
                   default=None,
                   help="code DC as a separate 1:8 kDCFrame (the "
                        "decoder can render a preview from it)")
    p.add_argument("--group_order", type=int, choices=(0, 1), default=0,
                   help="1 = center-first AC group order in the TOC "
                        "(permuted sections; decoders render the "
                        "center first)")
    p.add_argument("--center_x", type=int, default=None,
                   help="center for --group_order 1 (default: middle)")
    p.add_argument("--center_y", type=int, default=None)
    p.add_argument("--qprogressive_ac", type=int, choices=(0, 1),
                   default=None,
                   help="quantized (shift-based) AC progression; this "
                        "encoder's -p N ladder IS shift-based, so this "
                        "equals -p 2")
    p.add_argument("--modular_ma_tree_learning_percent", type=float,
                   default=None,
                   help="percent of samples used to learn the modular "
                        "MA tree (maps to the CART sample step)")
    for flag in ("--brotli_effort", "--faster_decoding",
                 "--modular_nb_prev_channels",
                 "--modular_channel_colors_global_percent",
                 "--modular_channel_colors_group_percent",
                 "--ec_resampling", "--keep_invisible", "--premultiply",
                 "--jpeg_reconstruction_cfl", "--upsampling_mode",
                 "--frame_indexing", "--pre_compact", "--post_compact"):
        p.add_argument(flag, type=float, default=None,
                       help=argparse.SUPPRESS)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the lossy encode's device stages: "
                        "cuda (the default; raises without a card) or cpu "
                        "(the kernels' plain twins)")
    p.add_argument("--host", action="store_true",
                   help="encode on the host (no device stage)")
    p.add_argument("--stats", action="store_true",
                   help="print per-layer bit accounting "
                        "(JxlEncoderCollectStats analog)")
    p.add_argument("--debug_heatmaps", default=None, metavar="PREFIX",
                   help="dump quant/sharpness/strategy heatmap PNGs")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def quality_to_distance(quality: float) -> float:
    """encode.cc JxlEncoderDistanceFromQuality mapping."""
    if quality >= 100:
        return 0.0
    if quality >= 30:
        return 0.1 + (100 - quality) * 0.09
    return 53.0 / 3000.0 * quality * quality - 23.0 / 20.0 * quality + 25.0


def main(argv=None):
    try:
        return _main(argv)
    except Exception as e:  # clean CLI error like cjxl_main.cc
        from ..base.status import JXLError

        if isinstance(e, (JXLError, OSError)):
            print(f"cjxl: error: {e}", file=sys.stderr)
            return 1
        raise


def _main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if "--version" in argv:
        print("cjxl (libjxl_tpu_torch)")
        return 0
    args = build_parser().parse_args(argv)
    device = None if args.host else args.device
    from ..extras.io import load_image
    from ..api.codestream import encode_lossless, encode_lossy
    from ..io.container import wrap_codestream

    if args.version:
        print("cjxl (libjxl_tpu_torch)")
        return 0
    if args.alpha_distance not in (0, 0.0, None):
        print("cjxl: warning: only lossless alpha (--alpha_distance 0) "
              "is supported; alpha stays lossless", file=sys.stderr)
    if args.distance > 25 and not args.allow_expert_options:
        print("cjxl: error: distance > 25 requires "
              "--allow_expert_options", file=sys.stderr)
        return 1
    if args.modular_group_size is not None:
        args.group_size_shift = args.modular_group_size

    if args.input.lower().endswith((".jpg", ".jpeg")) and args.lossless_jpeg:
        from ..jpeg.recompress import recompress_jpeg, recompress_jpeg_vardct

        with open(args.input, "rb") as f:
            jpg = f.read()
        t0 = time.perf_counter()
        # default: spec-style transcode into a real VarDCT YCbCr frame
        # (also directly viewable); --jpeg_transcode tokens = legacy
        # framework-specific model (a few % smaller)
        if getattr(args, "jpeg_transcode", "vardct") == "vardct":
            data = recompress_jpeg_vardct(jpg)
        else:
            data = recompress_jpeg(jpg)
        with open(args.output, "wb") as f:
            f.write(data)
        if args.verbose:
            print(f"Recompressed JPEG {len(jpg)} -> {len(data)} bytes "
                  f"({len(data) / len(jpg):.3f}x) in "
                  f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)
        return 0

    distance = args.distance
    if args.quality is not None:
        distance = quality_to_distance(args.quality)
    lossless = distance == 0.0 or args.modular == 1
    # animated input (APNG/GIF) -> animated codestream (dec/apng.cc,
    # dec/gif.cc analog via PIL frame iteration)
    if args.input.lower().endswith((".apng", ".gif", ".png")):
        anim = _try_encode_animated(args, lossless, distance, device)
        if anim is not None:
            with open(args.output, "wb") as f:
                f.write(anim)
            if args.verbose:
                print(f"Encoded animation ({len(anim)} bytes)",
                      file=sys.stderr)
            return 0
    image, icc = load_image(args.input, return_icc=True)

    def _encode_once():
        return _run_encode(args, image, icc, lossless, distance, device)

    t0 = time.perf_counter()
    data = _encode_once()
    dt = time.perf_counter() - t0
    for _ in range(max(0, args.num_reps - 1)):  # --num_reps benchmark
        t1 = time.perf_counter()
        _encode_once()  # identical options to the reported encode
        dt_r = time.perf_counter() - t1
        if not args.quiet:
            print(f"rep: {dt_r:.3f}s", file=sys.stderr)
    exif = xml = None
    if args.exif:
        with open(args.exif, "rb") as f:
            exif = f.read()
    if args.xmp:
        with open(args.xmp, "rb") as f:
            xml = f.read()
    if args.container or exif or xml or args.codestream_level != 5:
        data = wrap_codestream(data, level=args.codestream_level,
                               exif=exif, xml=xml,
                               compress_boxes=bool(args.compress_boxes))
    if not args.disable_output:
        with open(args.output, "wb") as f:
            f.write(data)
    if args.verbose and not args.quiet:
        h, w = image.shape[:2]
        mp = h * w / 1e6
        bpp = len(data) * 8 / (h * w)
        print(f"Encoded {w}x{h} ({'lossless' if lossless else f'd{distance}'})"
              f" to {len(data)} bytes ({bpp:.3f} bpp), "
              f"{mp / dt:.3f} MP/s", file=sys.stderr)
    return 0


def _run_encode(args, image, icc, lossless, distance, device):
    import sys

    from ..api.codestream import encode_lossless, encode_lossy

    if lossless:
        return encode_lossless(image,
                               group_size_shift=args.group_size_shift,
                               icc=icc, effort=args.effort,
                               responsive=bool(args.responsive),
                               bits_per_sample=args.override_bitdepth,
                               predictor=args.modular_predictor,
                               palette_colors=args.modular_palette_colors,
                               colorspace=args.modular_colorspace,
                               lossy_palette=bool(
                                   args.modular_lossy_palette),
                               ma_tree_learning_percent=(
                                   args.modular_ma_tree_learning_percent))
    if args.streaming:
        from ..api.codestream import encode_lossy_streaming

        return encode_lossy_streaming(image, distance=distance,
                                      hosts=args.hosts, device=device)
    if True:  # lossy still-image branch
        stats = {} if args.stats else None
        debug_cb = None
        if args.debug_heatmaps:
            from ..api.stats import save_heatmap

            def debug_cb(state, prefix=args.debug_heatmaps):
                save_heatmap(state.raw_quant_field, prefix + "_quant.png")
                save_heatmap(state.epf_sharpness, prefix + "_sharp.png")
                save_heatmap(state.strategy, prefix + "_acs.png")
        unwired = [f for f in (
            "brotli_effort", "faster_decoding",
            "modular_nb_prev_channels",
            "modular_channel_colors_global_percent",
            "modular_channel_colors_group_percent",
            "ec_resampling", "keep_invisible", "premultiply",
            "jpeg_reconstruction_cfl", "upsampling_mode",
            "frame_indexing", "pre_compact", "post_compact")
            if getattr(args, f, None) is not None]
        if unwired and args.verbose:
            print(f"cjxl: accepted (not wired): {', '.join(unwired)}",
                  file=sys.stderr)
        progressive = args.progressive
        if (args.progressive_ac or args.qprogressive_ac) \
                and progressive == 1:
            progressive = 2
        data = encode_lossy(image, distance=distance,
                            group_size_shift=args.group_size_shift, icc=icc,
                            effort=args.effort,
                            progressive=progressive,
                            resampling=args.resampling,
                            photon_noise_iso=args.photon_noise_iso,
                            preview=args.preview,
                            intensity_target=args.intensity_target,
                            iterations=args.iterations,
                            already_downsampled=args.already_downsampled,
                            progressive_dc=bool(args.progressive_dc),
                            group_order=args.group_order,
                            center_x=args.center_x,
                            center_y=args.center_y,
                            epf=args.epf if args.epf not in (None, -1)
                            else None,
                            gaborish=None if args.gaborish is None
                            else bool(args.gaborish),
                            dots=None if args.dots is None
                            else bool(args.dots),
                            patches=None if args.patches is None
                            else bool(args.patches),
                            noise=bool(args.noise) if args.noise else False,
                            stats=stats, debug_cb=debug_cb, device=device)
        if stats:
            for k, v in sorted(stats.items()):
                print(f"{k}: {v} bits ({v / 8:.0f} B)", file=sys.stderr)
        return data


def _try_encode_animated(args, lossless: bool, distance: float, device):
    """Returns an animated codestream if the input holds >1 frame,
    else None (caller falls back to still-image encode)."""
    import numpy as np
    from PIL import Image

    from ..api.codestream import encode_animation

    im = Image.open(args.input)
    if not getattr(im, "is_animated", False):
        return None
    frames = []
    durations_ms = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
        durations_ms.append(int(im.info.get("duration", 100)) or 100)
    # 1000 ticks/s keeps millisecond durations exact
    loops = int(im.info.get("loop", 0))
    return encode_animation(frames, fps_numerator=1000, fps_denominator=1,
                            num_loops=loops, lossless=lossless,
                            distance=distance if distance > 0 else 1.0,
                            durations=durations_ms, device=device)


if __name__ == "__main__":
    sys.exit(main())
