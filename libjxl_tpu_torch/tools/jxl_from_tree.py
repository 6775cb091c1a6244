"""jxl_from_tree: build a JPEG XL image from a hand-written MA tree.

Mirrors tools/jxl_from_tree.cc (grammar at :80-188, property/predictor
name tables) — a Modular-mode debugging tool: the tree IS the image
generator. The emitted codestream contains the tree, trivial (all-zero
residual) entropy streams and nothing else, so the decoder synthesizes
every pixel from the tree's predictors; file sizes are tiny.

The optional decoded image is decoded on --device (the CUDA card by
default: a missing card raises) or, under --host, on the host. The
stream is a modular one, so the decode renders it on the host either
way and launches no kernel (its path record is "host").

Usage: python -m libjxl_tpu_torch.tools.jxl_from_tree tree.txt out.jxl
       [out.png] [--device cuda|cpu] [--host]
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np

from ..base.device import add_device_args, cli_device
from ..base.status import JXLError
from ..io.bits import BitWriter
from ..modular.tree import TreeNode

PROPERTY_MAP = {
    "c": 0, "g": 1, "y": 2, "x": 3, "|N|": 4, "|W|": 5, "N": 6, "W": 7,
    "W-WW-NW+NWW": 8, "W+N-NW": 9, "W-NW": 10, "NW-N": 11, "N-NE": 12,
    "N-NN": 13, "W-WW": 14, "WGH": 15,
}
for _i in range(19):
    _p = f"Prev{_i + 1}"
    PROPERTY_MAP[_p + "Abs"] = _i * 4 + 16
    PROPERTY_MAP[_p] = _i * 4 + 17
    PROPERTY_MAP[_p + "AbsErr"] = _i * 4 + 18
    PROPERTY_MAP[_p + "Err"] = _i * 4 + 19
PROPERTY_MAP.update({"PrevAbs": 16, "Prev": 17, "PrevAbsErr": 18,
                     "PrevErr": 19, "PPrevAbs": 20, "PPrev": 21,
                     "PPrevAbsErr": 22, "PPrevErr": 23})

PREDICTOR_MAP = {
    "Set": 0, "W": 1, "N": 2, "AvgW+N": 3, "Select": 4, "Gradient": 5,
    "Weighted": 6, "NE": 7, "NW": 8, "WW": 9, "AvgW+NW": 10,
    "AvgN+NW": 11, "AvgN+NE": 12, "AvgAll": 13,
}


def _tokenize_source(text: str):
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return iter(text.split())


class TreeSpec:
    def __init__(self):
        self.width = 256
        self.height = 256
        self.bitdepth = 8
        self.rct = 0
        self.group_shift = 1
        self.tree: list = []


def parse_tree_file(text: str) -> TreeSpec:
    spec = TreeSpec()
    tok = _tokenize_source(text)

    def parse_node():
        t = next(tok)
        while t in ("Width", "Height", "Bitdepth", "RCT", "GroupShift"):
            v = next(tok)
            if t == "Width":
                spec.width = int(v)
            elif t == "Height":
                spec.height = int(v)
            elif t == "Bitdepth":
                spec.bitdepth = int(v)
            elif t == "RCT":
                spec.rct = int(v)
            elif t == "GroupShift":
                spec.group_shift = int(v)
            t = next(tok)
        if t == "if":
            prop_name = next(tok)
            if prop_name not in PROPERTY_MAP:
                raise JXLError(f"unknown property {prop_name!r}")
            gt = next(tok)
            if gt != ">":
                raise JXLError(f"expected >, found {gt!r}")
            split = int(next(tok))
            pos = len(spec.tree)
            spec.tree.append(TreeNode(PROPERTY_MAP[prop_name], split,
                                      pos + 1, 0, 0, 0, 1))
            parse_node()
            spec.tree[pos].rchild = len(spec.tree)
            parse_node()
        elif t == "-":
            pred_name = next(tok)
            if pred_name not in PREDICTOR_MAP:
                raise JXLError(f"unknown predictor {pred_name!r}")
            offset = 0
            if pred_name == "Set":
                offset = int(next(tok))
            else:
                try:
                    nxt = next(tok)
                except StopIteration:
                    nxt = None
                if nxt in ("+", "-"):
                    v = int(next(tok))
                    offset = v if nxt == "+" else -v
                elif nxt is not None:
                    # token belongs to the next node: push back via chain
                    nonlocal_pushback.append(nxt)
            spec.tree.append(TreeNode(-1, 0, 0, 0,
                                      PREDICTOR_MAP[pred_name], offset, 1))
        else:
            raise JXLError(f"unexpected token {t!r}")

    nonlocal_pushback: list = []
    real_next = tok

    class _Tok:
        def __iter__(self):
            return self

        def __next__(self):
            if nonlocal_pushback:
                return nonlocal_pushback.pop()
            return next(real_next)

    tok = _Tok()
    parse_node()
    return spec


def build_codestream(spec: TreeSpec) -> bytes:
    """Assemble headers + tree + all-zero-residual modular streams."""
    from ..api.codestream import write_codestream_header
    from ..api.frame import make_modular_frame_header
    from ..entropy.encode import TokenArray, build_and_encode_histograms, \
        write_tokens
    from ..io.headers import CodecMetadata, SizeHeader
    from ..io.toc import write_group_offsets
    from ..modular.codec import GroupHeader
    from ..modular.transforms import Transform, T_RCT
    from ..modular.tree import encode_tree, num_tree_contexts

    if max(spec.width, spec.height) > 128 << spec.group_shift:
        raise JXLError("image must fit in one group "
                       "(raise GroupShift, max 1024 px at shift 3)")
    meta = CodecMetadata()
    meta.size = SizeHeader().set(spec.width, spec.height)
    meta.m.all_default = False
    meta.m.xyb_encoded = False
    meta.m.bit_depth.bits_per_sample = spec.bitdepth
    writer = BitWriter()
    write_codestream_header(writer, meta)
    fh = make_modular_frame_header(meta, group_size_shift=spec.group_shift)
    fd = fh.frame_dimensions()

    tree_writer = BitWriter()
    dec_tree = encode_tree(spec.tree, tree_writer)
    n_tokens = 3 * spec.width * spec.height
    stream = [TokenArray(np.zeros(n_tokens, dtype=np.int32),
                         np.zeros(n_tokens, dtype=np.int64))]
    histo_writer = BitWriter()
    codes, context_map = build_and_encode_histograms(
        [stream], num_tree_contexts(dec_tree), histo_writer)

    transforms = []
    if spec.rct:
        t = Transform()
        t.id = T_RCT
        t.begin_c = 0
        t.rct_type = spec.rct
        transforms.append(t)

    sec = BitWriter()
    sec.write(1, 1)  # DequantMatrices::DecodeDC all_default
    sec.write(1, 1)  # has global tree
    sec.append_bits_from(tree_writer)
    sec.append_bits_from(histo_writer)
    gh = GroupHeader()
    gh.use_global_tree = True
    gh.transforms = transforms
    gh.write(sec)
    write_tokens(stream, codes, context_map, sec)
    section = sec.get_bytes()

    fh.write(writer)
    write_group_offsets([len(section)], None, writer)
    writer.zero_pad_to_byte()
    writer.append_bytes(section)
    return writer.get_bytes()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="build a JPEG XL image from a hand-written MA tree")
    p.add_argument("tree", help="tree description file")
    p.add_argument("output", help="output .jxl")
    p.add_argument("png", nargs="?", help="optional decoded .png")
    add_device_args(p, "the optional decode")
    args = p.parse_args(argv)
    with open(args.tree) as f:
        spec = parse_tree_file(f.read())
    data = build_codestream(spec)
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"{spec.width}x{spec.height} -> {len(data)} bytes")
    if args.png:
        from ..api.codestream import decode
        from ..extras.io import save_image

        img, _ = decode(data, device=cli_device(args))
        save_image(args.png, img)
        print(f"decoded to {args.png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
