"""Inputs of a VarDCT configuration: seeded photo-like images, encoded by
the frozen host encoder (jxlbench/refcodec) at the configuration's
distance, effort and EPF, and the frozen host decode of each stream as
its reference. Nothing here imports the program.

make(config, seed, index) gives (stream, reference u8 image, facts);
control(stream) gives the control's image (compare.bf16_stages).
"""

from __future__ import annotations

import numpy as np

from jxlbench import compare


def make_image(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Smooth photo-like content plus mild noise (chip_smoke.make_image,
    bench.py's generator), u8 (h, w, 3), its noise drawn from `rng`."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = (120 + 60 * np.sin(xx * 0.003) + 50 * np.cos(yy * 0.002 + 1)
           + 20 * np.sin((xx + yy) * 0.01) + rng.normal(0, 5, (h, w)))
    rgb = np.stack([img, img * 0.9 + 10, img * 1.1 - 12], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def image_for(config: dict, seed: int, index: int) -> np.ndarray:
    """The index-th image of the configuration at `seed`: every seed gives
    the same sizes, other noise."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), index])
    return make_image(config["height"], config["width"], rng)


def encode(config: dict, image: np.ndarray) -> bytes:
    """The configuration's codestream of `image` by the frozen encoder."""
    from jxlbench.refcodec.api import codestream

    kw = {}
    if config.get("epf") is not None:
        kw["epf"] = config["epf"]
    return codestream.encode_lossy(image, distance=config["distance"],
                                   effort=config["effort"], **kw)


def ac_tokens(state) -> int | None:
    """The AC symbols the frame's entropy decode reads, from the decoded
    coefficients: a symbol for each block's and channel's count of
    nonzeros, then one a coefficient in scan order up to its last nonzero.
    None unless every block is an 8x8 DCT (the device entropy decode's
    scope)."""
    from jxlbench.refcodec.vardct import ac_strategy as acs

    if np.any(state.strategy[state.is_origin] != acs.DCT):
        return None
    qimg = getattr(state, "qimg", None)
    fd = state.fd
    nby, nbx = fd.ysize_blocks, fd.xsize_blocks
    if qimg is None:
        qimg = np.zeros((3, nby * 8, nbx * 8), np.int32)
        for (by, bx), v in state.qblocks.items():
            qimg[:, by * 8:by * 8 + 8, bx * 8:bx * 8 + 8] = \
                np.asarray(v).reshape(3, 8, 8)
    blocks = np.asarray(qimg)[:, :nby * 8, :nbx * 8].reshape(
        3, nby, 8, nbx, 8).transpose(0, 1, 3, 2, 4).reshape(3, -1, 64)
    orders = state.orders[0] if state.orders else {}
    total = 0
    for c in range(3):
        order = orders.get((0, c))
        if order is None:
            order = acs.natural_coeff_order(acs.DCT)
        scan = blocks[c][:, np.asarray(order, np.int64)] != 0
        scan[:, 0] = False  # the DC is not coded here
        k = np.arange(64)
        last = np.where(scan, k, 0).max(axis=1)
        total += int(last.size + last.sum())
    return total


def reference(stream: bytes, lower=None):
    """(u8 image, the frame's decoder state) of the frozen host decode of
    `stream`. lower, when given, is a context manager that changes the
    decoder's precision for the decode (compare.bf16_stages, the
    control)."""
    from jxlbench.refcodec.api import codestream
    from jxlbench.refcodec.vardct import frame

    seen = {}
    render_groups = frame.render_groups

    def spy(state):
        render_groups(state)
        seen["state"] = state

    frame.render_groups = spy
    try:
        if lower is not None:
            with lower():
                img = codestream.decode(stream)[0]
        else:
            img = codestream.decode(stream)[0]
    finally:
        frame.render_groups = render_groups
    st = seen["state"]
    return img, st


def frame_filters(stream: bytes) -> tuple[int, bool]:
    """(epf_iters, gab) of the stream's first frame header."""
    from jxlbench.refcodec.api.codestream import parse_codestream_header
    from jxlbench.refcodec.io.bits import BitReader
    from jxlbench.refcodec.io.frame_header import FrameHeader

    r = BitReader(stream)
    meta = parse_codestream_header(r)
    fh = FrameHeader(meta)
    fh.read(r)
    return int(fh.loop_filter.epf_iters), bool(fh.loop_filter.gab)


def make(config: dict, seed: int, index: int):
    """(stream, reference image, facts) of the index-th stream at seed."""
    stream = encode(config, image_for(config, seed, index))
    img, st = reference(stream)
    epf_iters, gab = frame_filters(stream)
    return stream, img, {"bytes": len(stream),
                         "height": int(img.shape[0]),
                         "width": int(img.shape[1]),
                         "tokens": ac_tokens(st), "epf_iters": epf_iters,
                         "gab": gab}


def control(stream: bytes) -> np.ndarray:
    """The control's image of `stream`: the reference in bfloat16."""
    return reference(stream, lower=compare.bf16_stages)[0]
