"""jxlinfo — print JPEG XL file structure (tools/jxlinfo.c analog)."""

from __future__ import annotations

import argparse
import sys


def describe(data: bytes, verbose: bool = False) -> str:
    from ..io.bits import BitReader
    from ..io.container import extract_codestream, is_container, parse_boxes
    from ..io.frame_header import ENC_MODULAR, FT_REGULAR, FrameHeader
    from ..api.codestream import parse_codestream_header

    lines = []
    if is_container(data):
        lines.append("JPEG XL container (ISOBMFF)")
        for btype, payload, unbounded in parse_boxes(data[12:]):
            lines.append(f"  box {btype.decode('latin1')!r}: "
                         f"{len(payload)} bytes")
        codestream = extract_codestream(data)
    else:
        codestream = data
    r = BitReader(codestream)
    meta = parse_codestream_header(r)
    m = meta.m
    lines.append(f"dimensions: {meta.xsize()}x{meta.ysize()}")
    depth = f"{m.bit_depth.bits_per_sample}-bit"
    if m.bit_depth.floating_point_sample:
        depth += f" float ({m.bit_depth.exponent_bits_per_sample} exp bits)"
    lines.append(f"bit depth: {depth}")
    lines.append(f"xyb encoded: {m.xyb_encoded}")
    if m.num_extra_channels:
        names = {0: "Alpha", 1: "Depth", 2: "SpotColor",
                 3: "SelectionMask", 4: "Black", 5: "CFA", 6: "Thermal",
                 15: "Unknown", 16: "Optional"}
        kinds = ", ".join(names.get(e.type, str(e.type))
                          for e in m.extra_channel_info)
        lines.append(f"extra channels: {m.num_extra_channels}"
                     + (f" ({kinds})" if kinds else ""))
        if any(e.type == 4 for e in m.extra_channel_info):
            lines.append("color data: CMYK (kBlack channel present)")
    if m.have_animation:
        lines.append(
            f"animation: {m.animation.tps_numerator}/"
            f"{m.animation.tps_denominator} tps, loops={m.animation.num_loops}")
    cs = {0: "RGB", 1: "grayscale", 2: "XYB", 3: "unknown"}
    lines.append(f"color space: {cs.get(m.color_encoding.color_space)}")
    # first frame header
    fh = FrameHeader(meta)
    try:
        fh.read(r)
        enc = "Modular" if fh.encoding == ENC_MODULAR else "VarDCT"
        lines.append(f"frame: {enc}, type={fh.frame_type}, "
                     f"gab={fh.loop_filter.gab}, "
                     f"epf={fh.loop_filter.epf_iters}, "
                     f"passes={fh.passes.num_passes}, "
                     f"is_last={fh.is_last}")
    except Exception as e:  # pragma: no cover
        lines.append(f"frame: <unparseable: {e}>")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(prog="jxlinfo")
    p.add_argument("input")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    from ..extras.mmapio import read_mapped

    data = read_mapped(args.input)
    try:
        print(describe(data, args.verbose))
    except BrokenPipeError:  # e.g. `jxlinfo x.jxl | head`
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
