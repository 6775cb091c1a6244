"""Plain torch stages of the all-DCT8 VarDCT decode.

The port of libjxl_tpu/ops/pipeline.py's decode stages, with its function
names minus the `_jax` suffix and its layouts: images are f32[3, H, W]
planar XYB or RGB, and an explicit batch dimension may lead
([B, 3, H, W], per-block maps [B, nby, nbx]). Coefficients stay in the
bitstream's transposed per-block layout.

These are the plain twins of the hand-written kernels in ops/kernels.py
(decode_xyb_image for dequant_idct8, _epf_pass for epf_pass), and they are
what the CPU runs. The composed stages (epf, decode_render_image) call the
kernel wrappers, which take the kernel on a CUDA tensor and these plain
forms on a CPU tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..io.headers import (
    DEFAULT_INVERSE_OPSIN_MATRIX,
    DEFAULT_QUANT_BIAS,
    OPSIN_ABSORBANCE_BIAS,
)
from .dct import inv_matrix

COLOR_TILE_BLOCKS = 8
# the only chroma-from-luma parameters the batched path admits
# (api/tpu_codec.prepare_batch rejects others)
COLOR_FACTOR = 84.0
BASE_X = 0.0
BASE_B = 1.0


@functools.lru_cache(maxsize=None)
def _consts():
    return {
        "inv8": inv_matrix(8).astype(np.float32),
        "opsin_inv": np.asarray(DEFAULT_INVERSE_OPSIN_MATRIX,
                                dtype=np.float32),
        "bias": np.float32(OPSIN_ABSORBANCE_BIAS),
        "cbrt_bias": np.float32(OPSIN_ABSORBANCE_BIAS ** (1 / 3)),
        "qbias": np.asarray(DEFAULT_QUANT_BIAS, dtype=np.float32),
    }


def _const(name: str, device) -> torch.Tensor:
    return torch.as_tensor(_consts()[name], device=device)


def _mirror_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of jnp.pad(mode="symmetric"): -1 -> 0, n -> n-1."""
    i = torch.remainder(torch.arange(-pad, n + pad, device=device), 2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _pad_symmetric(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last two dims as jnp.pad(..., mode="symmetric") does (the
    edge sample repeats; torch's "reflect" mode does not)."""
    h, w = x.shape[-2:]
    x = x.index_select(-2, _mirror_index(h, pad, x.device))
    return x.index_select(-1, _mirror_index(w, pad, x.device))


def idct8_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Batched 8x8 IDCT of blocks in the bitstream's transposed layout
    ([hfreq][vfreq]); the einsum untransposes. fp32 with TF32 off
    (base/device.py) is the counterpart of Precision.HIGHEST."""
    inv8 = _const("inv8", blocks.device)
    return torch.einsum("ru,...vu,cv->...rc", inv8, blocks, inv8)


def adjust_quant_bias(q: torch.Tensor, c: int) -> torch.Tensor:
    qb = _consts()["qbias"]
    qf = q.to(torch.float32)
    safe = torch.where(qf == 0, 1.0, qf)
    general = qf - float(qb[3]) / safe
    return torch.where(qf == 0, 0.0,
                       torch.where(qf == 1, float(qb[c]),
                                   torch.where(qf == -1, -float(qb[c]),
                                               general)))


def xyb_to_rgb(xyb: torch.Tensor) -> torch.Tensor:
    k = _consts()
    cb, bias = float(k["cbrt_bias"]), float(k["bias"])
    x, y, b = xyb.unbind(-3)
    gr = y + x + cb
    gg = y - x + cb
    gb = b + cb
    mixed = torch.stack([gr * gr * gr - bias, gg * gg * gg - bias,
                         gb * gb * gb - bias], dim=-3)
    return torch.einsum("ij,...jhw->...ihw",
                        _const("opsin_inv", xyb.device), mixed)


def idct8_image(coeffs: torch.Tensor) -> torch.Tensor:
    """8x8 IDCT of image-layout coefficients [..., 3, H, W] stored in the
    bitstream's per-block transposed layout."""
    *lead, c, h, w = coeffs.shape
    blocks = coeffs.reshape(*lead, c, h // 8, 8, w // 8, 8).transpose(-3, -2)
    out = idct8_blocks(blocks)
    return out.transpose(-3, -2).reshape(*lead, c, h, w)


def _repeat2(m: torch.Tensor, n: int) -> torch.Tensor:
    return m.repeat_interleave(n, -2).repeat_interleave(n, -1)


def decode_xyb_image(qimg, qf, dc, ytox_map, ytob_map, dm,
                     inv_global_scale, x_dm_mult, b_dm_mult):
    """Dequant + AdjustQuantBias + CfL + DC insert + IDCT8 on
    image-layout coefficients.

    qimg: int[..., 3, H, W]; qf: i32[..., nby, nbx]; dc: f32[..., 3,
    nby, nbx]; ytox/ytob_map: i32[..., nty, ntx] per 64-px tile; dm:
    f32[3, 8, 8]; inv_global_scale: f32 per image. Returns f32[..., 3, H,
    W] XYB. Plain twin of kernels.dequant_idct8."""
    *lead, _, h, w = qimg.shape
    dev = qimg.device
    igs = torch.as_tensor(inv_global_scale, dtype=torch.float32, device=dev)
    scaled_b = igs[..., None, None] / qf.to(torch.float32)
    mult = (dm[:, None, :, None, :]
            * scaled_b[..., None, :, None, :, None]).reshape(*lead, 3, h, w)
    tile_px = 8 * COLOR_TILE_BLOCKS
    x_cc = BASE_X + _repeat2(ytox_map.to(torch.float32),
                             tile_px)[..., :h, :w] / COLOR_FACTOR
    b_cc = BASE_B + _repeat2(ytob_map.to(torch.float32),
                             tile_px)[..., :h, :w] / COLOR_FACTOR
    dq_y = adjust_quant_bias(qimg[..., 1, :, :], 1) * mult[..., 1, :, :]
    dq_x = adjust_quant_bias(qimg[..., 0, :, :], 0) * mult[..., 0, :, :] \
        * float(x_dm_mult) + x_cc * dq_y
    dq_b = adjust_quant_bias(qimg[..., 2, :, :], 2) * mult[..., 2, :, :] \
        * float(b_dm_mult) + b_cc * dq_y
    coeffs = torch.stack([dq_x, dq_y, dq_b], dim=-3)
    coeffs[..., 0::8, 0::8] = dc
    return idct8_image(coeffs)


def gaborish(xyb: torch.Tensor, kernels) -> torch.Tensor:
    """Decoder-side 3x3 Gaborish blur, per-channel kernels (3, 3, 3), as
    9 shifted weighted adds on a symmetric pad of 1 (no F.conv2d: that
    is cuDNN, which may run in TF32)."""
    k = torch.as_tensor(kernels, dtype=xyb.dtype, device=xyb.device)
    h, w = xyb.shape[-2:]
    p = _pad_symmetric(xyb, 1)
    out = None
    for dy in range(3):
        for dx in range(3):
            term = k[:, dy, dx][:, None, None] * p[..., dy:dy + h, dx:dx + w]
            out = term if out is None else out + term
    return out


_EPF_PLUS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
_EPF0_NEIGHBORS = ((-2, 0), (-1, -1), (-1, 0), (-1, 1), (0, -2), (0, -1),
                   (0, 1), (0, 2), (1, -1), (1, 0), (1, 1), (2, 0))
_EPF12_NEIGHBORS = ((-1, 0), (0, -1), (0, 1), (1, 0))
_EPF_MIN_SIGMA = -3.90524291751269967465540850526098


def _epf_pass(xyb, inv_sigma_px, sad_mul, channel_scale, neighbors,
              sad_pattern, sigma_scale):
    """One EPF pass (stage_epf.cc Weight math) on a symmetric pad of 4.

    inv_sigma_px: f32[..., H, W] per pixel; sad_mul: f32[H, W]. Plain
    twin of kernels.epf_pass, summing in _epf_pass_jax's order: one
    cross-difference plane per neighbour, then its 5 shifts."""
    pad = 4
    h, w = xyb.shape[-2:]
    p = _pad_symmetric(xyb, pad)

    def sh(dy, dx):
        return p[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w]

    cs = torch.tensor([float(c) for c in channel_scale], dtype=xyb.dtype,
                      device=xyb.device)[:, None, None]
    inv = inv_sigma_px * (sad_mul * float(sigma_scale) * 1.65)
    num = xyb
    den = torch.ones_like(xyb[..., 0, :, :])
    pr = max((max(abs(py), abs(px)) for (py, px) in sad_pattern or ()),
             default=0)
    for (dy, dx) in neighbors:
        if sad_pattern:
            y0 = x0 = pad - pr
            hd, wd = h + 2 * pr, w + 2 * pr
            base = p[..., y0:y0 + hd, x0:x0 + wd]
            shifted = p[..., y0 + dy:y0 + dy + hd, x0 + dx:x0 + dx + wd]
            d_plane = ((base - shifted).abs() * cs).sum(dim=-3)
            sad = None
            for (py, px) in sad_pattern:
                t = d_plane[..., pr + py:pr + py + h, pr + px:pr + px + w]
                sad = t if sad is None else sad + t
        else:
            sad = ((xyb - sh(dy, dx)).abs() * cs).sum(dim=-3)
        weight = torch.clamp_min(1.0 + sad * inv, 0.0)
        num = num + weight[..., None, :, :] * sh(dy, dx)
        den = den + weight
    out = num / den[..., None, :, :]
    skip = inv_sigma_px < _EPF_MIN_SIGMA
    return torch.where(skip[..., None, :, :], xyb, out)


def epf(xyb, inv_sigma, sad_mul, channel_scale, epf_iters,
        pass0_sigma_scale=0.9, pass2_sigma_scale=6.5):
    """Edge-preserving filter chain (stage_epf.cc). inv_sigma is per
    block, f32[..., nby, nbx], as the batched path stages it."""
    from .kernels import epf_pass

    if epf_iters == 3:
        xyb = epf_pass(xyb, inv_sigma, sad_mul, channel_scale,
                       _EPF0_NEIGHBORS, _EPF_PLUS, pass0_sigma_scale)
    if epf_iters >= 1:
        xyb = epf_pass(xyb, inv_sigma, sad_mul, channel_scale,
                       _EPF12_NEIGHBORS, _EPF_PLUS, 1.0)
    if epf_iters >= 2:
        xyb = epf_pass(xyb, inv_sigma, sad_mul, channel_scale,
                       _EPF12_NEIGHBORS, None, pass2_sigma_scale)
    return xyb


def srgb_u8(rgb: torch.Tensor) -> torch.Tensor:
    """Linear RGB f32[..., 3, H, W] -> sRGB u8[..., H, W, 3]."""
    low = rgb <= 0.0031308
    srgb = torch.where(low, rgb * 12.92,
                       1.055 * torch.clamp_min(rgb, 1e-12) ** (1 / 2.4)
                       - 0.055)
    u8 = torch.clamp(torch.round(srgb * 255.0), 0, 255).to(torch.uint8)
    return u8.movedim(-3, -1).contiguous()


def decode_render_image(qimg, qf, dc, ytox_map, ytob_map, dm,
                        inv_global_scale, x_dm_mult, b_dm_mult,
                        gab_kernels, inv_sigma, sad_mul, channel_scale,
                        epf_iters, to_rgb=True,
                        pass0_sigma_scale=0.9, pass2_sigma_scale=6.5,
                        extra_tiles=None, size_passes=None,
                        true_size=None):
    """All-DCT8 branch of the device decode on image-layout coefficients:
    dequant + IDCT8 -> true-size mirror -> Gaborish -> EPF -> output.

    inv_sigma is per block, f32[..., nby, nbx] (the JAX form takes it per
    pixel). to_rgb: "u8srgb" returns sRGB u8[..., H, W, 3], True linear
    RGB, False XYB. The other block strategies (size_passes,
    extra_tiles) belong to the single-image all-strategy render, which
    is not ported yet."""
    if size_passes or extra_tiles:
        raise NotImplementedError("decode_render_image: only the all-DCT8 "
                                  "branch is ported")
    from .kernels import dequant_idct8

    xyb = dequant_idct8(qimg, qf, dc, ytox_map, ytob_map, dm,
                        inv_global_scale, x_dm_mult, b_dm_mult)
    h, w = xyb.shape[-2:]
    if true_size is not None:
        # filters mirror at the FRAME edge, not the block-padded edge:
        # overwrite padding rows/cols with the symmetric reflection of
        # the true frame content (image_ops.h:184 Mirror semantics)
        th, tw = true_size
        if th < h:
            n = min(h - th, th)
            xyb[..., th:th + n, :] = xyb[..., th - n:th, :].flip(-2)
        if tw < w:
            n = min(w - tw, tw)
            xyb[..., :, tw:tw + n] = xyb[..., :, tw - n:tw].flip(-1)
    if gab_kernels is not None:
        xyb = gaborish(xyb, gab_kernels)
    if epf_iters > 0:
        xyb = epf(xyb, inv_sigma, sad_mul, channel_scale, epf_iters,
                  pass0_sigma_scale, pass2_sigma_scale)
    if to_rgb == "u8srgb":
        return srgb_u8(xyb_to_rgb(xyb))
    if to_rgb:
        return xyb_to_rgb(xyb)
    return xyb
