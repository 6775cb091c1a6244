"""djxl — JPEG XL decoder CLI (tools/djxl_main.cc analog).

Usage: python -m libjxl_tpu_torch.tools.djxl INPUT.jxl OUTPUT [options]

The pixel pipeline of a VarDCT frame runs on --device (the CUDA card by
default: a missing card raises; "cpu" runs the kernels' plain twins);
--host decodes on the host. JPEG reconstruction (a .jpg output of a
recompressed JPEG) runs on the host.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="djxl", description="JPEG XL decoder (PyTorch/CUDA)")
    p.add_argument("input", help="input .jxl file")
    p.add_argument("output", help="output image (png/pnm/npy)")
    p.add_argument("--display_nits", type=float, default=None,
                   help="tone-map HDR content to this display brightness")
    p.add_argument("--preview_out", default=None,
                   help="also decode the preview frame to this file")
    p.add_argument("--pixel_format", choices=["float32", "float16"],
                   default=None,
                   help="emit sRGB-transfer floats in [0,1] (the "
                        "JXL_TYPE_FLOAT/FLOAT16 output legs); pair "
                        "with .npy/.pfm/.exr outputs")
    p.add_argument("--allow_partial_files", action="store_true",
                   help="render the best partial image from a "
                        "truncated file (event-decoder flush) instead "
                        "of erroring")
    p.add_argument("--downsampling", type=int, choices=(1, 2, 4, 8),
                   default=1,
                   help="8: fast 1:8 preview from the DC sections only "
                        "(AC never decoded); 2/4: full decode + box "
                        "downsample")
    p.add_argument("--num_threads", type=int, default=0,
                   help="accepted for djxl compatibility")
    p.add_argument("--color_management", dest="color_management",
                   action="store_true", default=None,
                   help="force the decoder CMS stage (default: auto "
                        "when the stream embeds an RGB ICC profile)")
    p.add_argument("--no_color_management", dest="color_management",
                   action="store_false",
                   help="skip the CMS stage; output plain sRGB")
    p.add_argument("--low_memory", action="store_true",
                   help="bounded-memory group-at-a-time decode "
                        "(low_memory_render_pipeline.cc analog); falls "
                        "back to the regular decoder for streams with "
                        "whole-image features")
    p.add_argument("--host", action="store_true",
                   help="force the host (NumPy) render path; by default "
                        "the pixel pipeline runs on --device")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the pixel pipeline: cuda (the "
                        "default; raises without a card) or cpu (the "
                        "kernels' plain twins)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None):
    try:
        return _main(argv)
    except Exception as e:  # clean CLI error like djxl_main.cc
        from ..base.status import JXLError

        if isinstance(e, (JXLError, OSError)):
            print(f"djxl: error: {e}", file=sys.stderr)
            return 1
        raise


def _main(argv=None):
    args = build_parser().parse_args(argv)
    device = None if args.host else args.device
    from ..api.codestream import decode
    from ..extras.io import save_image
    from ..io.container import extract_codestream, is_container, parse_boxes

    from ..extras.mmapio import read_mapped

    data = read_mapped(args.input)
    # JPEG reconstruction path: container with a jbrd box
    if is_container(data):
        boxes = {t: p for t, p, _ in parse_boxes(data[12:])}
        jpeg_out = args.output.lower().endswith((".jpg", ".jpeg"))
        # a VarDCT transcode's YCbCr frame renders on the device like any
        # other frame; the host route and the token layout (jbrd 0x01,
        # no JPEG XL frame) decode the reconstructed JPEG's own pixels
        if b"jbrd" in boxes and (jpeg_out or device is None
                                 or boxes[b"jbrd"][:1] == b"\x01"):
            from ..jpeg.recompress import reconstruct_jpeg

            jpg = reconstruct_jpeg(data)
            if jpeg_out:
                with open(args.output, "wb") as f:
                    f.write(jpg)
                if args.verbose:
                    print(f"Reconstructed original JPEG ({len(jpg)} bytes)",
                          file=sys.stderr)
                return 0
            from ..jpeg import jpeg_to_pixels, parse_jpeg

            save_image(args.output, jpeg_to_pixels(parse_jpeg(jpg)).squeeze())
            return 0
    codestream = extract_codestream(data)
    # animated stream -> APNG when output is .apng (extras/enc/apng.cc
    # analog; also .png when the stream holds multiple frames)
    if args.output.lower().endswith(".apng"):
        return _write_apng(codestream, args, device)
    t0 = time.perf_counter()
    info = {}
    image = meta = None
    if args.allow_partial_files:
        from ..api.decoder import Decoder
        from ..base.status import JXLError

        from ..api.decoder import (FULL_IMAGE, NEED_MORE_INPUT,
                                   SUCCESS)

        dec = Decoder(device=device)
        dec.set_input(codestream)
        try:
            while dec.process() not in (NEED_MORE_INPUT, FULL_IMAGE,
                                        SUCCESS):
                pass
        except JXLError:
            # what a truncated stream raises; a device error propagates
            pass
        image = dec.flush_image()
        if image is None:
            print("djxl: error: nothing decodable in partial file",
                  file=sys.stderr)
            return 1
        save_image(args.output, image)
        if args.verbose:
            print(f"partial flush: {image.shape[1]}x{image.shape[0]}",
                  file=sys.stderr)
        return 0
    if args.downsampling == 8:
        from ..api.codestream import decode_dc

        t0 = time.perf_counter()
        image, meta = decode_dc(codestream)
        dt = time.perf_counter() - t0
        save_image(args.output, image)
        if args.verbose:
            h, w = image.shape[:2]
            print(f"DC preview {w}x{h} in {dt:.3f}s", file=sys.stderr)
        return 0
    if args.low_memory and args.pixel_format is not None:
        print("djxl: --low_memory emits integer rows; using the regular "
              "decoder for float output", file=sys.stderr)
        args.low_memory = False
    if args.low_memory and args.display_nits is not None:
        print("djxl: --low_memory has no tone-mapping stage; using the "
              "regular decoder", file=sys.stderr)
        args.low_memory = False
    if args.low_memory:
        from ..api.codestream import decode_rows, parse_codestream_header
        from ..base.status import JXLError
        from ..io.bits import BitReader

        try:
            import numpy as np

            parts = []
            for _y0, rows in decode_rows(codestream,
                                         num_threads=args.num_threads,
                                         device=device):
                parts.append(rows)
            image = np.concatenate(parts, axis=0)
            meta = parse_codestream_header(BitReader(codestream))
            info["path"] = "host:low-memory" if device is None \
                else f"low-memory on {device}"
        except JXLError as e:
            if args.verbose:
                print(f"low-memory path unavailable ({e}); "
                      "falling back", file=sys.stderr)
            image = None
    if image is None:
        image, meta = decode(codestream, target_nits=args.display_nits,
                             num_threads=args.num_threads,
                             device=device,
                             decode_info=info,
                             color_management=args.color_management,
                             pixel_format=args.pixel_format)
    dt = time.perf_counter() - t0
    if args.verbose:
        print(f"render path: {info.get('path')}", file=sys.stderr)
    if args.preview_out:
        from ..api.codestream import decode_preview

        pv, _ = decode_preview(codestream)
        if pv is not None:
            save_image(args.preview_out, pv)
        elif args.verbose:
            print("no preview frame in stream", file=sys.stderr)
    if args.downsampling in (2, 4):
        import numpy as np

        from ..render.upsample import downsample_box

        image = np.stack(
            [downsample_box(image[:, :, c].astype(np.float64),
                            args.downsampling)
             for c in range(image.shape[2])], axis=-1)
        image = np.clip(np.round(image), 0,
                        65535 if image.max() > 255 else 255).astype(
                            "uint16" if image.max() > 255 else "uint8")
    icc = meta.m.color_encoding.icc if meta.m.color_encoding.want_icc else None
    save_image(args.output, image, icc=icc)
    if args.verbose:
        h, w = image.shape[:2]
        print(f"Decoded {w}x{h} in {dt:.3f}s ({h * w / 1e6 / dt:.3f} MP/s)",
              file=sys.stderr)
    return 0


def _write_apng(codestream: bytes, args, device) -> int:
    """Decode all frames and write an animated PNG."""
    from PIL import Image

    from ..api.codestream import decode_frames, parse_codestream_header
    from ..io.bits import BitReader

    meta = parse_codestream_header(BitReader(codestream))
    anim = meta.m.animation
    tps = (anim.tps_numerator / max(1, anim.tps_denominator)
           if meta.m.have_animation else 10.0)
    frames = []
    durations = []
    for image, ticks in decode_frames(codestream, device=device):
        if image.ndim == 3 and image.shape[2] == 1:
            image = image[:, :, 0]
        frames.append(Image.fromarray(image))
        durations.append(max(1, round(1000.0 * max(1, ticks) / tps)))
    if not frames:
        print("djxl: error: no frames decoded", file=sys.stderr)
        return 1
    loops = anim.num_loops if meta.m.have_animation else 0
    frames[0].save(args.output, format="PNG", save_all=True,
                   append_images=frames[1:], duration=durations,
                   loop=loops, default_image=False)
    if args.verbose:
        print(f"Wrote {len(frames)} frames to {args.output}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
