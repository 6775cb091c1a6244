"""Inputs of a JPEG transcode configuration: seeded photo-like images
(vardct_photo.image_for), their baseline JPEG's coefficients at the
configuration's quality and 4:2:0 sampling, the lossless JPEG XL
recompression of those coefficients (jxlbench/refcodec/jpeg_transcode),
and as the reference the plain float64 decode of the same coefficients
(jxlbench/refs/jpeg_transcode_ref). Nothing here imports the program.

make(config, seed, index) gives (stream, reference u8 image, facts);
control(stream) gives the control's image: the reference of the
coefficients read back from the stream, each step's output rounded to
bfloat16.
"""

from __future__ import annotations

import numpy as np


def _reference(components, width, height, lower=None) -> np.ndarray:
    from jxlbench.refs import jpeg_transcode_ref as ref

    return ref.decode([ref.Component(*c) for c in components], width,
                      height, lower=lower)


def _bf16(t):
    import torch

    return t.to(torch.bfloat16).to(t.dtype)


def make(config: dict, seed: int, index: int):
    """(stream, reference image, facts) of the index-th stream at seed."""
    from jxlbench.makers import vardct_photo
    from jxlbench.refcodec import jpeg_transcode

    if config.get("sampling", "420") != "420":
        raise ValueError("the JPEG encoder writes 4:2:0 only")
    img = vardct_photo.image_for(config, seed, index)
    h, w = img.shape[:2]
    components = jpeg_transcode.jpeg_components(img, config["quality"])
    stream = jpeg_transcode.transcode(components, w, h)
    ref = _reference(components, w, h)
    return stream, ref, {"bytes": len(stream), "height": h, "width": w}


def control(stream: bytes) -> np.ndarray:
    """The control's image of `stream`: the reference in bfloat16."""
    from jxlbench.refcodec import jpeg_transcode

    components, w, h = jpeg_transcode.read_coefficients(stream)
    return _reference(components, w, h, lower=_bf16)
