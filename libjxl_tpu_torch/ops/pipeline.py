"""Plain torch stages of the all-DCT8 VarDCT decode.

The port of libjxl_tpu/ops/pipeline.py's decode stages, with its function
names minus the `_jax` suffix and its layouts: images are f32[3, H, W]
planar XYB or RGB, and an explicit batch dimension may lead
([B, 3, H, W], per-block maps [B, nby, nbx]). Coefficients stay in the
bitstream's transposed per-block layout.

These are the plain twins of the hand-written kernels in ops/kernels.py
(decode_xyb_image for dequant_idct8, render_tail_plain for render_tail,
_epf_pass for epf_pass), and they are what the CPU runs. decode_render_image
calls the kernel wrappers, which take the kernel on a CUDA tensor and these
plain forms on a CPU tensor. render_tail_tiled runs the render tail tile by
tile as the kernel does (halos, per-stage mirror refills at the frame
edge), in plain torch.
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


def srgb_u8(rgb: torch.Tensor) -> torch.Tensor:
    """Linear RGB f32[..., 3, H, W] -> sRGB u8[..., H, W, 3]."""
    low = rgb <= 0.0031308
    srgb = torch.where(low, rgb * 12.92,
                       1.055 * torch.clamp_min(rgb, 1e-12) ** (1 / 2.4)
                       - 0.055)
    u8 = torch.clamp(torch.round(srgb * 255.0), 0, 255).to(torch.uint8)
    return u8.movedim(-3, -1).contiguous()


# EPF passes by epf_iters (stage_epf.cc), and each pass's geometry:
# (neighbours, SAD pattern)
EPF_CHAINS = {0: (), 1: (1,), 2: (1, 2), 3: (0, 1, 2)}
EPF_GEOMETRY = {0: (_EPF0_NEIGHBORS, _EPF_PLUS),
                1: (_EPF12_NEIGHBORS, _EPF_PLUS),
                2: (_EPF12_NEIGHBORS, None)}
GABORISH_RADIUS = 1


def _reach(offsets) -> int:
    return max((max(abs(dy), abs(dx)) for dy, dx in offsets or ()),
               default=0)


def epf_radius(epf_pass: int) -> int:
    """Pixels a side an EPF pass reads beyond its output: the farthest
    neighbour plus the SAD pattern's reach (3, 2 and 1 for passes 0-2)."""
    neighbors, pattern = EPF_GEOMETRY[epf_pass]
    return _reach(neighbors) + _reach(pattern)


def _tail_stages(gab_kernels, epf_passes, channel_scale, sigma_scales):
    """The render tail's stages as (radius, fn(xyb, inv_sigma_px,
    sad_mul)), in order. sigma_scales: each pass's, by pass number."""
    stages = []
    if gab_kernels is not None:
        stages.append((GABORISH_RADIUS,
                       lambda x, isp, sad: gaborish(x, gab_kernels)))
    for p in epf_passes:
        neighbors, pattern = EPF_GEOMETRY[p]

        def one(x, isp, sad, neighbors=neighbors, pattern=pattern,
                scale=sigma_scales[p]):
            return _epf_pass(x, isp, sad, channel_scale, neighbors, pattern,
                             scale)

        stages.append((epf_radius(p), one))
    return stages


def _sigma_scales(pass0_sigma_scale, pass2_sigma_scale):
    return {0: pass0_sigma_scale, 1: 1.0, 2: pass2_sigma_scale}


def render_tail_plain(xyb, gab_kernels, inv_sigma, sad_mul, channel_scale,
                      epf_iters, pass0_sigma_scale=0.9, pass2_sigma_scale=6.5,
                      out="xyb"):
    """Gaborish (unless gab_kernels is None) -> the EPF passes of
    epf_iters -> out: "xyb" f32[..., 3, H, W] or "u8srgb" sRGB
    u8[..., H, W, 3]. inv_sigma is per block, f32[..., ceil(H/8),
    ceil(W/8)]; sad_mul f32[H, W]. Plain twin of kernels.render_tail."""
    h, w = xyb.shape[-2:]
    isp = _repeat2(inv_sigma, 8)[..., :h, :w] if epf_iters else None
    for _, stage in _tail_stages(
            gab_kernels, EPF_CHAINS[epf_iters], channel_scale,
            _sigma_scales(pass0_sigma_scale, pass2_sigma_scale)):
        xyb = stage(xyb, isp, sad_mul)
    return srgb_u8(xyb_to_rgb(xyb)) if out == "u8srgb" else xyb


def _tile_index(origin: int, size: int, n: int, depth: int | None,
                device) -> torch.Tensor:
    """Where each of a tile buffer's `size` cells, from image index
    `origin`, takes its value along one axis: depth None, the image index
    (the load: mirrored once at the frame edge, clamped); else the buffer
    index (a refill: an out-of-image cell within `depth` of the frame takes
    its mirror cell, every other cell itself). render_tail.cu's load_tile
    and refill_edge."""
    i = torch.arange(origin, origin + size, device=device)
    m = torch.where(i < 0, -1 - i, torch.where(i >= n, 2 * n - 1 - i, i))
    if depth is None:
        return m.clamp(0, n - 1)
    refill = ((i < 0) & (i >= -depth)) | ((i >= n) & (i < n + depth))
    return torch.where(refill, m - origin, i - origin)


def render_tail_tiled(xyb, gab_kernels, inv_sigma, sad_mul, channel_scale,
                      epf_iters, pass0_sigma_scale=0.9,
                      pass2_sigma_scale=6.5, *, tile):
    """render_tail_plain's XYB output computed as kernels.render_tail's
    kernel computes it, in plain torch: for each (rows, cols) `tile`, a
    buffer of the tile and a halo of the stages' summed radii, loaded
    through a mirrored index; each stage run on the buffer; after each
    stage the buffer's out-of-image cells within the later stages' reach
    refilled from the mirror of that stage's output (every stage of the
    reference pads its own input symmetrically). Needs H, W >= the
    halo."""
    th, tw = tile
    h, w = xyb.shape[-2:]
    dev = xyb.device
    stages = _tail_stages(
        gab_kernels, EPF_CHAINS[epf_iters], channel_scale,
        _sigma_scales(pass0_sigma_scale, pass2_sigma_scale))
    halo = sum(r for r, _ in stages)
    if min(h, w) < halo:
        raise ValueError(f"render_tail_tiled: {h}x{w} is below the halo "
                         f"{halo}")
    isp = _repeat2(inv_sigma, 8)[..., :h, :w] if epf_iters else None
    out = torch.empty_like(xyb)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            oy, ox = y0 - halo, x0 - halo
            sy, sx = th + 2 * halo, tw + 2 * halo
            rows = _tile_index(oy, sy, h, None, dev)
            cols = _tile_index(ox, sx, w, None, dev)
            buf = xyb[..., rows, :][..., cols]
            ibuf = None if isp is None else isp[..., rows, :][..., cols]
            sbuf = sad_mul[rows][:, cols]
            depth = halo
            for radius, stage in stages:
                buf = stage(buf, ibuf, sbuf)
                depth -= radius
                if depth:
                    buf = buf[..., _tile_index(oy, sy, h, depth, dev), :][
                        ..., _tile_index(ox, sx, w, depth, dev)]
            rh, rw = min(th, h - y0), min(tw, w - x0)
            out[..., y0:y0 + rh, x0:x0 + rw] = \
                buf[..., halo:halo + rh, halo:halo + rw]
    return out


def mirror_to_true_size(xyb: torch.Tensor, true_size) -> torch.Tensor:
    """In place: the block padding past the frame's true (ysize, xsize)
    takes the symmetric reflection of the frame content, so that the
    filters mirror at the FRAME edge (image_ops.h:184 Mirror semantics).
    Returns xyb."""
    h, w = xyb.shape[-2:]
    th, tw = true_size
    if th < h:
        n = min(h - th, th)
        xyb[..., th:th + n, :] = xyb[..., th - n:th, :].flip(-2)
    if tw < w:
        n = min(w - tw, tw)
        xyb[..., :, tw:tw + n] = xyb[..., :, tw - n:tw].flip(-1)
    return xyb


def decode_render_image(qimg, qf, dc, ytox_map, ytob_map, dm,
                        inv_global_scale, x_dm_mult, b_dm_mult,
                        gab_kernels, inv_sigma, sad_mul, channel_scale,
                        epf_iters, to_rgb=True,
                        pass0_sigma_scale=0.9, pass2_sigma_scale=6.5,
                        extra_tiles=None, size_passes=None,
                        true_size=None):
    """All-DCT8 branch of the device decode on image-layout coefficients:
    dequant + IDCT8 (kernels.dequant_idct8) -> true-size mirror ->
    Gaborish -> EPF -> output (kernels.render_tail); on a CUDA tensor two
    kernel launches whatever the filters.

    inv_sigma is per block, f32[..., nby, nbx] (the JAX form takes it per
    pixel). to_rgb: "u8srgb" returns sRGB u8[..., H, W, 3], True linear
    RGB, False XYB. The other block strategies (size_passes,
    extra_tiles) belong to the single-image all-strategy render, which
    is not ported yet."""
    if size_passes or extra_tiles:
        raise NotImplementedError("decode_render_image: only the all-DCT8 "
                                  "branch is ported")
    from .kernels import dequant_idct8, render_tail

    xyb = dequant_idct8(qimg, qf, dc, ytox_map, ytob_map, dm,
                        inv_global_scale, x_dm_mult, b_dm_mult)
    if true_size is not None:
        mirror_to_true_size(xyb, true_size)
    out = render_tail(xyb, gab_kernels, inv_sigma, sad_mul, channel_scale,
                      epf_iters, pass0_sigma_scale, pass2_sigma_scale,
                      out="u8srgb" if to_rgb == "u8srgb" else "xyb")
    if to_rgb == "u8srgb" or not to_rgb:
        return out
    return xyb_to_rgb(out)
