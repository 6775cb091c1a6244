"""How a frame's host state is staged for the device renders and the
encode step: the per-frame tables as numpy arrays, scalars rounded to
f32, and the upload of whatever holds them.

api/tpu_codec (the batch, single-image and encode paths),
vardct/low_memory (the device strips) and vardct/streaming (the chunk
step) all stage through these, so the three paths hand the device the
same tensors. per_block turns the JAX forms' per-pixel EPF sigma into
the per-block grid render_tail reads (parallel/sharding's builders,
ops/kernels.decode_render_blocks).
"""

from __future__ import annotations

import numpy as np
import torch

from ..render.pipeline import _sad_mul_map, compute_sigma, gaborish_kernel


def dequant_tables(st):
    """The DCT8 dequant matrices f32[3, 64] of a frame's state."""
    return np.stack([st.matrices.dequant_matrix(0, c)
                     for c in range(3)]).astype(np.float32)


def gab_kernels(lf):
    """The Gaborish kernels f32[3, 3, 3] of a frame's loop filter; None
    without Gaborish."""
    if not lf.gab:
        return None
    return np.stack([gaborish_kernel(getattr(lf, f"gab_{ch}_weight1"),
                                     getattr(lf, f"gab_{ch}_weight2"))
                     for ch in "xyb"]).astype(np.float32)


def block_sigma(state, lf):
    """The EPF inverse sigma per BLOCK, f32[nby, nbx] (64x less to upload
    than per pixel; the kernel reads it per block); zeros without EPF."""
    if lf.epf_iters > 0:
        return compute_sigma(lf, state.quantizer.global_scale_float,
                             state.raw_quant_field,
                             state.epf_sharpness).astype(np.float32)
    return np.zeros((state.fd.ysize_blocks, state.fd.xsize_blocks),
                    dtype=np.float32)


def sad_mul(lf, h, w):
    """The EPF SAD multiplier map f32[h, w] (ones without EPF)."""
    if lf.epf_iters > 0:
        return _sad_mul_map(h, w, lf.epf_border_sad_mul).astype(np.float32)
    return np.ones((h, w), dtype=np.float32)


def f32(v) -> float:
    """A host scalar rounded to f32, as the JAX path hands it over."""
    return float(np.float32(v))


def to_device(obj, dev):
    """`obj` with every numpy array in it, inside tuples, lists and dicts,
    as a contiguous tensor on dev."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj)).to(dev)
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(o, dev) for o in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, dev) for k, v in obj.items()}
    return obj


UNEVEN_SIGMA = ("{}: inv_sigma_px is not constant on each 8x8 block "
                "(render_tail reads sigma per block)")


def block_values(inv_sigma_px):
    """(per block, uneven): the per-pixel EPF inverse sigma f32[..., H, W]
    (H, W multiples of 8) at each block's first pixel, as render_tail
    reads it, and a 0-d bool tensor on its device, set where some block
    is not constant. No host sync: a program's form of per_block."""
    blocks = inv_sigma_px[..., ::8, ::8]
    uneven = (blocks.repeat_interleave(8, -2).repeat_interleave(8, -1)
              != inv_sigma_px).any()
    return blocks, uneven


def per_block(inv_sigma_px, what: str) -> torch.Tensor:
    """The per-pixel EPF inverse sigma f32[..., H, W] (H, W multiples of
    8; a numpy array or a tensor) as render_tail reads it, per block:
    raises unless it is constant on every 8x8 block."""
    blocks, uneven = block_values(torch.as_tensor(inv_sigma_px))
    if bool(uneven):
        raise ValueError(UNEVEN_SIGMA.format(what))
    return blocks
