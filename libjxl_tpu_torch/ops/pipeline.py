"""Plain torch stages of the VarDCT decode and encode.

The port of libjxl_tpu/ops/pipeline.py's stages, with its function
names minus the `_jax` suffix and its layouts: images are f32[3, H, W]
planar XYB or RGB, and an explicit batch dimension may lead
([B, 3, H, W], per-block maps [B, nby, nbx]) on the all-DCT8 stages.
Coefficients stay in the bitstream's transposed per-block layout.

Some are the plain twins of the hand-written kernels in ops/kernels.py
(decode_xyb_image for dequant_idct8, render_tail_plain for render_tail,
_epf_pass for epf_pass; decode_pixels and decode_render, the decode on
block-layout coefficients i32[..., 3, nby, nbx, 8, 8], for the routes
decode_pixels_hybrid and decode_render_blocks), and they are what the
CPU runs.
decode_render_image and decode_render_subsampled call the kernel
wrappers, which take the kernel on a CUDA tensor and these plain forms on
a CPU tensor. The other block strategies' inverse transforms
(decode_special_tiles, decode_big_tiles, decode_size_pass), which the
reference left to XLA, are torch ops on either device. render_tail_tiled
runs the render tail tile by tile as the kernel does (halos, per-stage
mirror refills at the frame edge), in plain torch. The encode stages
(encode_step and what it calls, and the sharded encode's
encode_coefficients, at the end) have no hand kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..io.headers import (
    DEFAULT_INVERSE_OPSIN_MATRIX,
    DEFAULT_QUANT_BIAS,
    OPSIN_ABSORBANCE_BIAS,
    OPSIN_ABSORBANCE_MATRIX,
)
from . import programs
from .dct import fwd_matrix, inv_matrix

COLOR_TILE_BLOCKS = 8
# the only chroma-from-luma parameters the batched path admits
# (api/tpu_codec.prepare_batch rejects others)
COLOR_FACTOR = 84.0
BASE_X = 0.0
BASE_B = 1.0


@functools.lru_cache(maxsize=None)
def _consts():
    return {
        "fwd8": fwd_matrix(8).astype(np.float32),
        "inv8": inv_matrix(8).astype(np.float32),
        "opsin": np.asarray(OPSIN_ABSORBANCE_MATRIX, dtype=np.float32),
        "opsin_inv": np.asarray(DEFAULT_INVERSE_OPSIN_MATRIX,
                                dtype=np.float32),
        "bias": np.float32(OPSIN_ABSORBANCE_BIAS),
        "cbrt_bias": np.float32(OPSIN_ABSORBANCE_BIAS ** (1 / 3)),
        "qbias": np.asarray(DEFAULT_QUANT_BIAS, dtype=np.float32),
    }


def _const(name: str, device) -> torch.Tensor:
    """_consts()[name] as a tensor on `device`, uploaded once a device."""
    return programs.constant(name, device, lambda: _consts()[name])


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
    xyb = _filter_chain(xyb, gab_kernels, isp, sad_mul, channel_scale,
                        epf_iters, pass0_sigma_scale, pass2_sigma_scale)
    return srgb_u8(xyb_to_rgb(xyb)) if out == "u8srgb" else xyb


def _filter_chain(xyb, gab_kernels, inv_sigma_px, sad_mul, channel_scale,
                  epf_iters, pass0_sigma_scale, pass2_sigma_scale):
    """Gaborish (unless gab_kernels is None), then the EPF passes of
    epf_iters, with the inverse sigma per pixel."""
    for _, stage in _tail_stages(
            gab_kernels, EPF_CHAINS[epf_iters], channel_scale,
            _sigma_scales(pass0_sigma_scale, pass2_sigma_scale)):
        xyb = stage(xyb, inv_sigma_px, sad_mul)
    return xyb


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


def _block_to_px(block_map: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(nby, nbx) per-block values -> (H, W) per-pixel."""
    return _repeat2(block_map, 8)[..., :h, :w]


@functools.lru_cache(maxsize=None)
def special_matrix(strategy: int) -> np.ndarray:
    """(64, 64) f32: pixels_flat = M @ coeffs_flat for an 8x8-tile
    strategy (IDENTITY/DCT2X2/DCT4X4/DCT8X4/DCT4X8/AFV0-3 and DCT8).
    Every TransformToPixels case is linear, so the whole per-strategy
    special-case code collapses to one matmul on the device."""
    from ..vardct.transforms import transform_to_pixels

    m = np.zeros((64, 64), dtype=np.float64)
    for k in range(64):
        e = np.zeros(64)
        e[k] = 1.0
        m[:, k] = transform_to_pixels(strategy, e.reshape(8, 8)).reshape(64)
    return m.astype(np.float32)


def _dequant_cfl(q, dm, s, x_cc, b_cc, x_dm_mult, b_dm_mult, dim):
    """Dequant + AdjustQuantBias + CfL of coefficients q whose channel
    axis is `dim`: channel c's weights dm[c], the scale s and the CfL
    factors x_cc/b_cc broadcast against q.select(dim, c). Returns the f32
    coefficients stacked on `dim`."""
    dq_y = adjust_quant_bias(q.select(dim, 1), 1) * dm[1] * s
    dq_x = adjust_quant_bias(q.select(dim, 0), 0) * dm[0] * s \
        * float(x_dm_mult) + x_cc * dq_y
    dq_b = adjust_quant_bias(q.select(dim, 2), 2) * dm[2] * s \
        * float(b_dm_mult) + b_cc * dq_y
    return torch.stack([dq_x, dq_y, dq_b], dim=dim)


def decode_special_tiles(q, dc, scaled, x_cc, b_cc, dm_kind, mat,
                         x_dm_mult, b_dm_mult):
    """Batched dequant + CfL + inverse transform for one 8x8-tile
    strategy. q: int[n, 3, 64]; dc: f32[n, 3]; scaled/x_cc/b_cc: f32[n];
    dm_kind: f32[3, 64]; mat: f32[64, 64]. Returns f32[n, 3, 8, 8]."""
    co = _dequant_cfl(q, dm_kind, scaled[:, None], x_cc[:, None],
                      b_cc[:, None], x_dm_mult, b_dm_mult, 1)
    co[:, :, 0] = dc
    pix = torch.einsum("ncs,ps->ncp", co, mat)
    return pix.reshape(-1, 3, 8, 8)


def decode_big_tiles(q, dc_tiles, scaled, x_cc, b_cc, dm_kind,
                     x_dm_mult, b_dm_mult, rows, cols, llf_sy, llf_sx):
    """Batched dequant + LLF-from-DC + IDCT for one plain-DCT size above
    8x8 (vardct.frame._render_dct_batch on the device).

    q: int[n, 3, wr, wc] wide layout; dc_tiles: f32[n, 3, cy, cx];
    dm_kind: f32[3, wr, wc]; llf_sy/llf_sx: f32 resample scales.
    Returns f32[n, 3, rows, cols] pixel tiles."""
    from .dct import torch_dct2d, torch_idct2d

    s = scaled[:, None, None]
    co = _dequant_cfl(q, dm_kind, s, x_cc[:, None, None],
                      b_cc[:, None, None], x_dm_mult, b_dm_mult, 1)
    cy, cx = dc_tiles.shape[-2:]
    llf = torch_dct2d(dc_tiles, cy, cx) / (llf_sy[:, None] * llf_sx[None, :])
    lh, lw = min(cy, cx), max(cy, cx)
    co[:, :, :lh, :lw] = llf
    return torch_idct2d(co, rows, cols)


def decode_size_pass(qimg, qf_px, dc, ytox_px, ytob_px, dm_tile,
                     x_dm_mult, b_dm_mult, rows, cols, llf_sy, llf_sx,
                     llf_mask_tile):
    """Dense full-grid dequant + LLF + IDCT for one plain-DCT tile size
    (rows, cols), 16x16 .. 64x64. No gathers or scatters: every aligned
    tile of the grid is transformed and the caller selects the pixels
    whose covering block really uses this size.

    qf_px/ytox_px/ytob_px: per-pixel f32 maps (constant within a tile by
    construction); dm_tile: f32[3, rows, cols] dequant weights laid out
    in tile order; llf_mask_tile: bool[rows, cols] True at LLF slots.
    Returns f32[3, H, W]."""
    from .dct import torch_dct2d, torch_idct2d

    _, h, w = qimg.shape
    nty, ntx = h // rows, w // cols
    cy, cx = rows // 8, cols // 8
    wr, wc = min(rows, cols), max(rows, cols)
    dmt = dm_tile.repeat(1, nty, ntx)
    co = _dequant_cfl(qimg, dmt, qf_px, ytox_px, ytob_px, x_dm_mult,
                      b_dm_mult, 0)
    # LLF from DC: per-tile DCT of the (cy, cx) DC patch, rescaled
    # (LowestFrequenciesFromDC, dec_transforms-inl.h:688-816)
    dct = dc.reshape(3, nty, cy, ntx, cx).transpose(2, 3)
    llf = torch_dct2d(dct, cy, cx) / (llf_sy[:, None] * llf_sx[None, :])
    lh, lw = llf.shape[-2:]
    # LLF lives at wide-layout [:lh, :lw]; the tile stores the wide array
    # reshaped row-major to (rows, cols)
    llf_wide = llf.new_zeros((3, nty, ntx, wr, wc))
    llf_wide[..., :lh, :lw] = llf
    llf_img = llf_wide.reshape(3, nty, ntx, rows, cols).transpose(
        2, 3).reshape(3, h, w)
    mask_img = llf_mask_tile.repeat(nty, ntx)
    co = torch.where(mask_img, llf_img, co)
    # IDCT: tile layout row-major == wide layout reshaped; reshape back
    wide = co.reshape(3, nty, rows, ntx, cols).transpose(2, 3).reshape(
        3, nty, ntx, wr, wc)
    pix = torch_idct2d(wide, rows, cols)
    return pix.transpose(2, 3).reshape(3, h, w)


def scatter_tiles(acc5, pix, ys, xs):
    """Add aligned (rows, cols) pixel tiles pix f32[n, 3, rows, cols] into
    the 5-D image view acc5 (3, H//rows, rows, W//cols, cols) at tile
    indices (ys, xs), in place; returns acc5. The tiles of one strategy
    never overlap; only the batch's zero padding tiles share (0, 0), and
    adding zero is exact in any order."""
    acc5.permute(1, 3, 0, 2, 4).index_put_(
        (ys.long(), xs.long()), pix, accumulate=True)
    return acc5


def _over(v, t: torch.Tensor) -> torch.Tensor:
    """v / t for v a float, or one f32 on t's device (a program's input,
    divided without a host sync), in the form torch gives `float / t`:
    t.reciprocal() * v, so that both give the same bits."""
    if isinstance(v, torch.Tensor):
        return t.reciprocal() * v.to(torch.float32).reshape(())
    return float(v) / t


def render_size_passes(xyb, qimg, qf, dc, ytox_map, ytob_map,
                       inv_global_scale, x_dm_mult, b_dm_mult, size_passes,
                       size_shapes, class_map):
    """xyb f32[3, H, W] with the pixels whose block class_map gives size
    pass i + 1 taken from that dense pass's output (a new tensor)."""
    _, h, w = xyb.shape
    cls_px = _repeat2(class_map, 8)
    scaled_px = _block_to_px(_over(inv_global_scale,
                                   qf.to(torch.float32)), h, w)
    tile_px = 8 * COLOR_TILE_BLOCKS
    xcc_px = BASE_X + _repeat2(ytox_map.to(torch.float32),
                               tile_px)[:h, :w] / COLOR_FACTOR
    bcc_px = BASE_B + _repeat2(ytob_map.to(torch.float32),
                               tile_px)[:h, :w] / COLOR_FACTOR
    for i, (sp, (rows, cols)) in enumerate(zip(size_passes, size_shapes)):
        pix = decode_size_pass(
            qimg, scaled_px, dc, xcc_px, bcc_px, sp["dm_tile"], x_dm_mult,
            b_dm_mult, rows, cols, sp["llf_sy"], sp["llf_sx"],
            sp["llf_mask"])
        xyb = torch.where(cls_px == i + 1, pix, xyb)
    return xyb


def render_extra_tiles(xyb, extra_tiles, tile_shapes, x_dm_mult, b_dm_mult,
                       class_map):
    """xyb f32[3, H, W] with the tiles of the remaining strategies (8x8
    specials, above 64 px, unaligned) at the blocks with class_map < 0 (a
    new tensor)."""
    _, h, w = xyb.shape
    acc = torch.zeros_like(xyb)
    for b, (rows, cols) in zip(extra_tiles, tile_shapes):
        if rows == 8 and cols == 8:
            pix = decode_special_tiles(
                b["q"], b["dc"], b["scaled"], b["x_cc"], b["b_cc"], b["dm"],
                b["mat"], x_dm_mult, b_dm_mult)
        else:
            pix = decode_big_tiles(
                b["q"], b["dc"], b["scaled"], b["x_cc"], b["b_cc"], b["dm"],
                x_dm_mult, b_dm_mult, rows, cols, b["llf_sy"], b["llf_sx"])
        scatter_tiles(acc.view(3, h // rows, rows, w // cols, cols), pix,
                      b["ys"], b["xs"])
    return torch.where(_repeat2(class_map, 8) < 0, acc, xyb)


def decode_render_image(qimg, qf, dc, ytox_map, ytob_map, dm,
                        inv_global_scale, x_dm_mult, b_dm_mult,
                        gab_kernels, inv_sigma, sad_mul, channel_scale,
                        epf_iters, to_rgb=True,
                        pass0_sigma_scale=0.9, pass2_sigma_scale=6.5,
                        extra_tiles=None, tile_shapes=None,
                        size_passes=None, size_shapes=None, class_map=None,
                        true_size=None):
    """The device decode on image-layout coefficients: dequant + IDCT8 of
    every block (kernels.dequant_idct8) -> the other strategies' blocks
    (render_size_passes, render_extra_tiles; torch ops) -> true-size
    mirror -> Gaborish -> EPF -> output (kernels.render_tail). On a CUDA
    tensor two kernel launches whatever the strategies and filters.

    inv_sigma is per block, f32[..., nby, nbx] (the JAX form takes it per
    pixel). to_rgb: "u8srgb" returns sRGB u8[..., H, W, 3], True linear
    RGB, False XYB. size_passes: per-size dicts of the dense plain-DCT
    passes, size_shapes their (rows, cols); class_map: i32[nby, nbx], 0 =
    DCT8, i + 1 = size pass i, -1 = an extra tile. extra_tiles: per-batch
    dicts of the remaining strategies, tile_shapes their (rows, cols).
    The strategy branch takes one image ([3, H, W]); the all-DCT8 form
    also takes a batch."""
    from .kernels import dequant_idct8, render_tail

    xyb = dequant_idct8(qimg, qf, dc, ytox_map, ytob_map, dm,
                        inv_global_scale, x_dm_mult, b_dm_mult)
    if size_passes:
        xyb = render_size_passes(xyb, qimg, qf, dc, ytox_map, ytob_map,
                                 inv_global_scale, x_dm_mult, b_dm_mult,
                                 size_passes, size_shapes, class_map)
    if extra_tiles:
        xyb = render_extra_tiles(xyb, extra_tiles, tile_shapes, x_dm_mult,
                                 b_dm_mult, class_map)
    if true_size is not None:
        mirror_to_true_size(xyb, true_size)
    out = render_tail(xyb, gab_kernels, inv_sigma, sad_mul, channel_scale,
                      epf_iters, pass0_sigma_scale, pass2_sigma_scale,
                      out="u8srgb" if to_rgb == "u8srgb" else "xyb")
    if to_rgb == "u8srgb" or not to_rgb:
        return out
    return xyb_to_rgb(out)


def ycbcr_to_rgb(planes: torch.Tensor) -> torch.Tensor:
    """Full-range BT.601 (stage_ycbcr.cc:31-52): (Cb, Y, Cr) planes f32[3,
    H, W] -> RGB in [0, 1]."""
    cb, y, cr = planes.unbind(0)
    yp = y + float(np.float32(128.0 / 255))
    r = yp + 1.402 * cr
    g = yp + float(np.float32(-0.114 * 1.772 / 0.587)) * cb \
        + float(np.float32(-0.299 * 1.402 / 0.587)) * cr
    b = yp + 1.772 * cb
    return torch.stack([r, g, b])


def _upsample_axis(plane: torch.Tensor, dim: int, n: int, extent: int,
                   shift: int) -> torch.Tensor:
    """The first n samples along dim of a channel upsampled by 2 ** shift
    (libjxl's stage_chroma_upsampling.cc, one axis): output 2x is 0.75
    in[x] + 0.25 in[x - 1], output 2x + 1 is 0.75 in[x] + 0.25 in[x + 1],
    an index outside the channel's extent replaced by its edge; outputs
    past twice the extent repeat its last output. shift 0: the first n
    samples. The host's form is vardct/subsampled.upsample_taps."""
    if not shift:
        return plane.narrow(dim, 0, n)
    o = torch.arange(n, device=plane.device).clamp_(max=2 * extent - 1)
    x = o >> 1
    nb = (x - 1 + 2 * (o & 1)).clamp_(0, extent - 1)
    return 0.75 * plane.index_select(dim, x) \
        + 0.25 * plane.index_select(dim, nb)


def decode_render_subsampled(qs, dcs, scaled_maps, dm, gab_kernels,
                             inv_sigma, sad_mul, channel_scale, shifts,
                             epf_iters=0, gab=False, pass0_sigma_scale=0.9,
                             pass2_sigma_scale=6.5, to_u8=False,
                             true_size=None):
    """The device decode of a chroma-subsampled YCbCr DCT8 frame
    (dec_group.cc:569 quant-from-luma + stage_chroma_upsampling +
    stage_ycbcr): per-channel dequant + IDCT8 at native resolution (torch
    ops), libjxl's linear chroma upsampling (_upsample_axis), Gaborish/EPF
    on the block-padded luma-size planes, mirrored past true_size (one
    kernels.render_tail launch, XYB form, whatever the filters), BT.601,
    then the crop to true_size.

    qs: 3 x int[nbyc*8, nbxc*8] dense transposed-layout coefficients;
    dcs: 3 x f32[nbyc, nbxc] unquantized DC; scaled_maps: 3 x f32[nbyc,
    nbxc] per-block inv_global_scale/quant (from the luma quant field);
    dm: f32[3, 8, 8]; inv_sigma per block f32[nby, nbx] of the luma plane
    (the JAX form takes it per pixel) and sad_mul f32[h, w], both None
    without EPF; shifts: (hs, vs) per channel.
    Returns RGB f32[3, h, w] or, with to_u8, u8[h, w, 3]."""
    from .kernels import render_tail

    # the frame's block-padded size (the luma plane's) and true size
    h, w = qs[1].shape[0] << shifts[1][1], qs[1].shape[1] << shifts[1][0]
    th, tw = true_size if true_size is not None else (h, w)
    planes = []
    for c in range(3):
        q = qs[c]
        nby, nbx = q.shape[0] // 8, q.shape[1] // 8
        blocks = q.reshape(nby, 8, nbx, 8).transpose(1, 2)
        co = adjust_quant_bias(blocks, c) * dm[c] \
            * scaled_maps[c][:, :, None, None]
        co[:, :, 0, 0] = dcs[c]
        plane = idct8_blocks(co).transpose(1, 2).reshape(nby * 8, nbx * 8)
        hs, vs = shifts[c]
        plane = _upsample_axis(plane, 1, w, -(-tw >> hs), hs)
        planes.append(_upsample_axis(plane, 0, h, -(-th >> vs), vs))
    ycc = torch.stack(planes)
    if true_size is not None and (gab or epf_iters):
        # the filters mirror at the frame's edge, as the host's
        # apply_restoration and the XYB render do
        mirror_to_true_size(ycc, true_size)
    ycc = render_tail(ycc, gab_kernels if gab else None, inv_sigma, sad_mul,
                      channel_scale, epf_iters, pass0_sigma_scale,
                      pass2_sigma_scale, out="xyb")
    rgb = ycbcr_to_rgb(ycc)
    if true_size is not None:
        rgb = rgb[:, :true_size[0], :true_size[1]]
    if to_u8:
        # YCbCr VarDCT frames carry display-space values: no transfer
        u8 = torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.uint8)
        return u8.permute(1, 2, 0).contiguous()
    return rgb


# ------------------------------------------------------------------ encode
# The device encode stages (libjxl_tpu/ops/pipeline.py's encode_step and
# what it calls; libjxl_tpu/api/tpu_codec.py's srgb2lin). The TPU ran them
# as one XLA program, no Pallas kernel; here they are plain torch ops on
# the caller's device. Every expression keeps the reference's order of
# operations: a quantized value is a rounding of these floats.

def srgb2lin(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB transfer -> linear, f32."""
    low = srgb <= 0.04045
    return torch.where(low, srgb / 12.92, _powf((srgb + 0.055) / 1.055, 2.4))


def blocks_to_image(blocks: torch.Tensor) -> torch.Tensor:
    """[..., c, nby, nbx, 8, 8] -> [..., c, nby*8, nbx*8] (a copy)."""
    *lead, c, nby, nbx, _, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, c, nby * 8, nbx * 8)


def image_to_blocks(image: torch.Tensor) -> torch.Tensor:
    """[..., c, H, W] -> [..., c, H/8, W/8, 8, 8] (a view)."""
    *lead, c, h, w = image.shape
    return image.reshape(*lead, c, h // 8, 8, w // 8, 8).transpose(-3, -2)


def dct8_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of idct8_blocks: pixels -> transposed-layout coefficients
    (fp32, TF32 off)."""
    fwd8 = _const("fwd8", blocks.device)
    return torch.einsum("ur,...rc,vc->...vu", fwd8, blocks, fwd8)


def _powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """f32 x ** y (x >= 0) as the C library's powf computes it: the f32
    exponent, the power in fp64, one rounding to f32. XLA's CPU backend
    (the reference's) calls powf for pow and for cbrt (as
    powf(x, f32(1/3))): this form differs from it in ~0.07% of values by
    an ulp, torch's own f32 pow in ~1.3% (x ** (1/3)) and ~17% (x ** 2.4),
    and a quantized coefficient follows its float across a rounding
    boundary."""
    return x.double().pow(float(np.float32(y))).to(x.dtype)


def rgb_to_xyb(rgb: torch.Tensor) -> torch.Tensor:
    """Linear RGB f32[3, H, W] -> XYB (the opsin mix, bias, cube root)."""
    k = _consts()
    mixed = torch.einsum("ij,jhw->ihw", _const("opsin", rgb.device),
                         rgb) + float(k["bias"])
    mixed = torch.clamp_min(mixed, 0.0)
    cbrt = _powf(mixed, 1 / 3) - float(k["cbrt_bias"])
    return torch.stack([0.5 * (cbrt[0] - cbrt[1]),
                        0.5 * (cbrt[0] + cbrt[1]), cbrt[2]])


def _tile_to_blocks(tile_map: torch.Tensor, nby: int,
                    nbx: int) -> torch.Tensor:
    """Expand a per-64px-tile map [..., nty, ntx] to per-block values,
    cropped (never wrapped) to [..., nby, nbx]."""
    return _repeat2(tile_map, COLOR_TILE_BLOCKS)[..., :nby, :nbx]


def decode_xyb(qcoeffs, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
               x_dm_mult, b_dm_mult, color_factor=COLOR_FACTOR,
               base_x=BASE_X, base_b=BASE_B):
    """The VarDCT decode on block-layout coefficients to XYB, the JAX
    package's decode_xyb (DequantBlock, dec_group.cc:96-165, then
    TransformToPixels): dequant + AdjustQuantBias + CfL in the block
    layout, the DC insert, the batched 8x8 IDCT.

    qcoeffs: int[..., 3, nby, nbx, 8, 8] (the bitstream's transposed
    per-block layout); qf: i32[..., nby, nbx]; dc: f32[..., 3, nby, nbx],
    already dequantized; ytox/ytob_map: i32[..., nty, ntx] per 64-px tile;
    dm: f32[3, 8, 8]; inv_global_scale: f32, or one per image. Returns
    f32[..., 3, nby*8, nbx*8]. Plain twin of the dequant_idct8 launch in
    kernels.decode_pixels_hybrid and kernels.decode_render_blocks."""
    nby, nbx = qf.shape[-2:]
    dev = qcoeffs.device
    igs = torch.as_tensor(inv_global_scale, dtype=torch.float32, device=dev)
    scaled = (igs[..., None, None] / qf.to(torch.float32))[..., None, None]
    x_cc = (base_x + _tile_to_blocks(ytox_map, nby, nbx).to(torch.float32)
            / color_factor)[..., None, None]
    b_cc = (base_b + _tile_to_blocks(ytob_map, nby, nbx).to(torch.float32)
            / color_factor)[..., None, None]
    dm = torch.as_tensor(dm, dtype=torch.float32, device=dev)
    qx, qy, qb = qcoeffs.unbind(-5)
    dq_y = adjust_quant_bias(qy, 1) * dm[1] * scaled
    dq_x = adjust_quant_bias(qx, 0) * dm[0] * scaled * float(x_dm_mult) \
        + x_cc * dq_y
    dq_b = adjust_quant_bias(qb, 2) * dm[2] * scaled * float(b_dm_mult) \
        + b_cc * dq_y
    coeffs = torch.stack([dq_x, dq_y, dq_b], dim=-5)
    coeffs[..., 0, 0] = dc
    return blocks_to_image(idct8_blocks(coeffs))


def decode_pixels(qcoeffs, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
                  x_dm_mult, b_dm_mult, color_factor=COLOR_FACTOR,
                  base_x=BASE_X, base_b=BASE_B):
    """decode_xyb, then XYB -> linear RGB f32[..., 3, nby*8, nbx*8]: the
    JAX package's decode_pixels, the path __graft_entry__.entry() runs.
    Plain twin of kernels.decode_pixels_hybrid."""
    return xyb_to_rgb(decode_xyb(qcoeffs, qf, dc, ytox_map, ytob_map, dm,
                                 inv_global_scale, x_dm_mult, b_dm_mult,
                                 color_factor, base_x, base_b))


def decode_render(qcoeffs, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
                  x_dm_mult, b_dm_mult, gab_kernels, inv_sigma_px, sad_mul,
                  channel_scale, epf_iters, to_rgb=True,
                  pass0_sigma_scale=0.9, pass2_sigma_scale=6.5):
    """The full decode on block-layout coefficients, the JAX package's
    decode_render: decode_xyb -> Gaborish (unless gab_kernels is None)
    -> the EPF passes of epf_iters -> linear RGB (to_rgb) or XYB.
    inv_sigma_px: f32[..., H, W] per pixel; sad_mul: f32[H, W]. Plain
    twin of kernels.decode_render_blocks."""
    xyb = decode_xyb(qcoeffs, qf, dc, ytox_map, ytob_map, dm,
                     inv_global_scale, x_dm_mult, b_dm_mult)
    xyb = _filter_chain(xyb, gab_kernels, inv_sigma_px, sad_mul,
                        channel_scale, epf_iters, pass0_sigma_scale,
                        pass2_sigma_scale)
    return xyb_to_rgb(xyb) if to_rgb else xyb


def _fma(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to f32, as a fused multiply-add: the product
    is exact in fp64 and the sum rounds there first (a double rounding
    that differs from one f32 rounding only when the fp64 sum lands on an
    f32 tie). XLA's CPU backend contracts the reference's multiply-adds
    into FMAs; torch's elementwise ops round each product."""
    return (b.double() * float(a) + c.double()).to(c.dtype)


def gaborish_inverse(xyb: torch.Tensor, kernel) -> torch.Tensor:
    """5x5 sharpen (GaborishInverse, enc_gaborish.cc:21-49) as 25 shifted
    weighted multiply-adds (fused, as the reference's compiled form) on a
    symmetric pad of 2; kernel: f32[5, 5], the same for all channels."""
    k = np.asarray(kernel, dtype=np.float32)
    h, w = xyb.shape[-2:]
    p = _pad_symmetric(xyb, 2)
    out = None
    for dy in range(5):
        for dx in range(5):
            tap = p[:, dy:dy + h, dx:dx + w]
            out = float(k[dy, dx]) * tap if out is None \
                else _fma(k[dy, dx], tap, out)
    return out


def _pad_edge(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last two dims as jnp.pad(..., mode="edge") does."""
    h, w = x.shape[-2:]
    iy = torch.arange(-pad, h + pad, device=x.device).clamp(0, h - 1)
    ix = torch.arange(-pad, w + pad, device=x.device).clamp(0, w - 1)
    return x.index_select(-2, iy).index_select(-1, ix)


def _block_sum(img: torch.Tensor, nby: int, nbx: int) -> torch.Tensor:
    return img.reshape(nby, 8, nbx, 8).sum(dim=(1, 3))


def quant_field(y: torch.Tensor, nby: int, nbx: int, base_quant: float,
                quant_max: int):
    """heuristics.initial_quant_field + epf_sharpness_field: per-block
    masking from local Y activity. Returns (quant_field i32, sharpness
    i32, uniformly 4 as the reference's fast tiers set it)."""
    h, w = nby * 8, nbx * 8
    yp = y[:h, :w]
    gy = torch.diff(yp, dim=0, prepend=yp[:1]).abs()
    gx = torch.diff(yp, dim=1, prepend=yp[:, :1]).abs()
    grad = (gy + gx).reshape(nby, 8, nbx, 8).mean(dim=(1, 3))
    act = torch.log1p(grad * 80.0)
    mod = torch.clamp(1.6 - 0.35 * act, 0.55, 1.8)
    qf = torch.clamp(torch.round(float(base_quant) * mod), 1,
                     quant_max).to(torch.int32)
    sharp = torch.full((nby, nbx), 4, dtype=torch.int32, device=y.device)
    return qf, sharp


def adaptive_quant_field(xyb: torch.Tensor, nby: int, nbx: int,
                         distance: float, rescale: float = 1.0):
    """AdaptiveQuantizationMap (heuristics.initial_quant_field_full,
    enc_adaptive_quantization.cc:85-660): the per-block float quant
    field f32[nby, nbx] of the pre-sharpening XYB image."""
    from ..vardct.heuristics import _LOG2, _SG_MUL, _SG_RETMUL, _SG_VOFFSET

    quant_ac = 0.725 / max(distance, 1e-3)
    scale = quant_ac * rescale
    h, w = nby * 8, nbx * 8
    yp = xyb[1][:h, :w]
    xp = xyb[0][:h, :w]
    bp = xyb[2][:h, :w]

    def ratio_cbrt_gamma(v, invert=False):
        eps = 1e-2
        v = torch.clamp_min(v, 0.0)
        num = (_SG_RETMUL * 3 * _SG_MUL) * v * v + eps
        den = (_LOG2 * _SG_MUL) * v * v * v + (_SG_VOFFSET * _LOG2 + eps)
        return num / den if invert else den / num

    # per-pixel masking diff
    p = _pad_edge(yp, 1)
    base = 0.25 * (p[2:, 1:-1] + p[:-2, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])
    gammac = ratio_cbrt_gamma(yp + 0.019)
    diff = torch.clamp_max((gammac * (yp - base)) ** 2, 0.2)
    k_log_offset = 27.505837037000106
    k_mul = 211.66567973503678
    diff = 0.25 * torch.sqrt(diff * float(np.sqrt(k_mul * 1e8))
                             + k_log_offset)
    pre = diff.reshape(h // 4, 4, w // 4, 4).sum(dim=(1, 3)) * 0.25

    # FuzzyErosion: weighted 4 smallest of the 9-neighbourhood
    mul = max(0.0, min(1.0, (2.0 - distance) / 2.0)) if distance < 2.0 \
        else 0.0
    k = np.array([0.125, 0.10 - mul * 0.10, 0.09 - mul * 0.09,
                  0.06 - mul * 0.06])
    k *= 0.29959705784054957 / k.sum()
    pp = _pad_edge(pre, 1)
    hh, ww = pre.shape
    neigh = torch.stack([pp[1 + dy:1 + dy + hh, 1 + dx:1 + dx + ww]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    part = torch.sort(neigh, dim=0).values
    eroded = (float(k[0]) * part[0] + float(k[1]) * part[1]
              + float(k[2]) * part[2] + float(k[3]) * part[3])
    aq = eroded.reshape(nby, 2, nbx, 2).sum(dim=(1, 3))

    # ComputeMask rational polynomial
    v1 = torch.clamp_min(aq * 0.80061762862741759, 1e-3)
    v2 = 1.0 / (v1 + 302.59587815579727)
    v3 = 1.0 / (v1 * v1 + 3.7179635626140772)
    v4 = 1.0 / (v1 * v1 + 0.25 * 3.7179635626140772)
    out = (-0.7647 + 9.4708735624378946 * v4 + 17.35036561631863 * v2
           + 6.7943250517376494 * v3)

    # HfModulation: intra-block capped |gradient| sums
    vmin = 0.0206
    dx_ = torch.clamp_max((yp[:, 1:] - yp[:, :-1]).abs(), vmin)
    dy_ = torch.clamp_max((yp[1:, :] - yp[:-1, :]).abs(), vmin)
    dx_ = torch.nn.functional.pad(dx_, (0, 1))
    dy_ = torch.nn.functional.pad(dy_, (0, 0, 0, 1))
    col = (torch.arange(w, device=xyb.device) % 8) != 7
    row = (torch.arange(h, device=xyb.device) % 8) != 7
    dx_ = dx_ * col[None, :]
    dy_ = dy_ * row[:, None]
    hf = _block_sum(dx_, nby, nbx) + _block_sum(dy_, nby, nbx)
    out = out + hf * -0.38 + 0.42

    # GammaModulation
    r = ratio_cbrt_gamma(yp + 0.16 - xp, invert=True)
    g = ratio_cbrt_gamma(yp + 0.16 + xp, invert=True)
    overall = (_block_sum(r, nby, nbx) + _block_sum(g, nby, nbx)) \
        * (0.5 / 64)
    out = out + 0.1005613337192697 * torch.log2(
        torch.clamp_min(overall, 1e-9))

    # BlueModulation
    k_limit = 0.027121074570634722
    k_offset = 0.084381641171960495
    p_y_eff = bp - (yp + k_offset + xp.abs())
    contrib = torch.where(p_y_eff > 0, torch.clamp_max(p_y_eff, k_limit),
                          0.0)
    s = _block_sum(contrib, nby, nbx)
    s = torch.where(s >= 32 * k_limit, 64 * k_limit - s, s)
    s = torch.clamp_max(s, 15.398788439047934 * k_limit)
    out = out + s * 0.14207000358439159

    # final mapping: exp with distance-dependent dampening
    base_level = 0.48 * scale
    dampen = max(0.0, 1.0 - (distance - 2.0) / 12.0) if distance >= 2.0 \
        else 1.0
    return torch.exp(out) * (scale * dampen) + (1.0 - dampen) * base_level


def fit_cfl(co: torch.Tensor, color_factor: float = 84.0,
            base_b: float = 1.0):
    """heuristics.fit_cfl: per-64x64-tile least squares of the X and B
    coefficients against Y, LLF excluded. co: f32[3, nby, nbx, 8, 8], nby
    and nbx multiples of 8. Returns (ytox, ytob) i32[nby//8, nbx//8]."""
    _, nby, nbx, _, _ = co.shape
    tby, tbx = nby // COLOR_TILE_BLOCKS, nbx // COLOR_TILE_BLOCKS
    mask = torch.ones((8, 8), dtype=torch.float32, device=co.device)
    mask[0, 0].fill_(0.0)  # a fill, not a host copy: capture-safe
    cm = co * mask
    t = cm.reshape(3, tby, COLOR_TILE_BLOCKS, tbx, COLOR_TILE_BLOCKS, 64)
    ys = t[1]
    denom = (ys * ys).sum(dim=(1, 3, 4)) + 1e-9
    rx = (t[0] * ys).sum(dim=(1, 3, 4)) / denom
    rb = (t[2] * ys).sum(dim=(1, 3, 4)) / denom
    ytox = torch.clamp(torch.round(rx * color_factor), -128, 127)
    ytob = torch.clamp(torch.round((rb - base_b) * color_factor), -128, 127)
    return ytox.to(torch.int32), ytob.to(torch.int32)


def encode_step(rgb, dm_inv, dm, gab_kernel, inv_global_scale, base_quant,
                x_dm_mult, b_dm_mult, quant_max=255, color_factor=84.0,
                adaptive=True, cfl=True, qf_in=None, distance=None):
    """The device VarDCT encode step (ComputeCoefficients and the
    LossyFrameHeuristics subset): linear RGB f32[3, H, W], H and W
    multiples of 8 -> (q i32[3, nby, nbx, 8, 8], dc, qf, ytox, ytob,
    sharp). dm_inv, dm: f32[3, 8, 8]; the scalars are f32 values. DC is
    the unquantized f32[3, nby, nbx] DCT DC (the host quantizes it)."""
    xyb = rgb_to_xyb(rgb)
    if qf_in is None and adaptive and distance is not None:
        # the full AdaptiveQuantizationMap on the PRE-sharpening opsin
        # image (enc_heuristics.cc:1105); the host fixes only the global
        # scale (the 0.39/d anchor)
        _, h, w = xyb.shape
        field = adaptive_quant_field(xyb, h // 8, w // 8, distance)
        qf_in = torch.clamp(field * float(inv_global_scale) + 0.5, 1,
                            quant_max).to(torch.int32)
    if gab_kernel is not None:
        xyb = gaborish_inverse(xyb, gab_kernel)
    return encode_step_xyb(xyb, dm_inv, dm, inv_global_scale, base_quant,
                           x_dm_mult, b_dm_mult, quant_max, color_factor,
                           adaptive, cfl, qf_in)


def encode_step_xyb(xyb, dm_inv, dm, inv_global_scale, base_quant,
                    x_dm_mult, b_dm_mult, quant_max=255, color_factor=84.0,
                    adaptive=True, cfl=True, qf_in=None):
    """encode_step from the (already sharpened) XYB image: the streaming
    encoder's per-DC-group step, whose inverse-Gaborish border context
    comes from the neighbouring chunks."""
    from ..vardct.frame import _deadzone_thresholds

    dev = xyb.device
    _, h, w = xyb.shape
    nby, nbx = h // 8, w // 8
    if qf_in is not None:
        # a precomputed raw quant field; the sharpness stays uniform
        qf = qf_in
        _, sharp = quant_field(xyb[1], nby, nbx, base_quant, quant_max)
    elif adaptive:
        qf, sharp = quant_field(xyb[1], nby, nbx, base_quant, quant_max)
    else:
        qf = torch.full((nby, nbx), int(np.float32(base_quant)),
                        dtype=torch.int32, device=dev)
        sharp = torch.full((nby, nbx), 4, dtype=torch.int32, device=dev)
    co = dct8_blocks(image_to_blocks(xyb))
    # CfL tile fit on the tile grid, padded with zero blocks
    tby = -(-nby // COLOR_TILE_BLOCKS)
    tbx = -(-nbx // COLOR_TILE_BLOCKS)
    if cfl:
        co_p = torch.nn.functional.pad(
            co, (0, 0, 0, 0, 0, tbx * COLOR_TILE_BLOCKS - nbx,
                 0, tby * COLOR_TILE_BLOCKS - nby))
        ytox_map, ytob_map = fit_cfl(co_p, color_factor)
    else:
        ytox_map = torch.zeros((tby, tbx), dtype=torch.int32, device=dev)
        ytob_map = torch.zeros((tby, tbx), dtype=torch.int32, device=dev)
    scaled = (float(inv_global_scale)
              / qf.to(torch.float32))[:, :, None, None]
    x_cc = (0.0 + _tile_to_blocks(ytox_map, nby, nbx).to(torch.float32)
            / color_factor)[:, :, None, None]
    b_cc = (1.0 + _tile_to_blocks(ytob_map, nby, nbx).to(torch.float32)
            / color_factor)[:, :, None, None]

    def dz(vals, c):
        # dead-zone thresholds (QuantizeBlockAC, enc_group.cc:46-91)
        thr = programs.constant(
            f"deadzone{c}", dev, lambda: np.asarray(
                _deadzone_thresholds(1, 1, c), dtype=np.float32))
        return torch.where(vals.abs() < thr, 0.0, torch.round(vals))

    dm_inv = torch.as_tensor(dm_inv, dtype=torch.float32, device=dev)
    dm = torch.as_tensor(dm, dtype=torch.float32, device=dev)
    qy = dz(co[1] * dm_inv[1] / scaled, 1)
    dy = adjust_quant_bias(qy, 1) * dm[1] * scaled
    qx = dz((co[0] - x_cc * dy) * dm_inv[0]
            / (scaled * float(x_dm_mult)), 0)
    qb = dz((co[2] - b_cc * dy) * dm_inv[2]
            / (scaled * float(b_dm_mult)), 2)
    q = torch.stack([qx, qy, qb]).to(torch.int32)
    q[:, :, :, 0, 0].fill_(0)
    dc = co[:, :, :, 0, 0]
    return q, dc, qf, ytox_map, ytob_map, sharp


def encode_coefficients(rgb, qf, dm_inv, dm_y, inv_global_scale, x_dm_mult,
                        b_dm_mult, inv_dc_quant_mul):
    """The sharded encode's compute (ComputeCoefficients analog,
    enc_group.cc:370-520): linear RGB f32[3, H, W] -> XYB -> DCT8 ->
    rounding quantization, CfL at base_b 1 on the B channel, no dead zone.

    qf: i32[nby, nbx]; dm_inv: f32[3, 8, 8] quant weights; dm_y: f32[8, 8]
    the Y dequant matrix; inv_dc_quant_mul: f32[3], 1 / mul_dc(c). Returns
    (q i32[3, nby, nbx, 8, 8] with the LLF zeroed, qdc i32[3, nby, nbx])."""
    dev = rgb.device
    co = dct8_blocks(image_to_blocks(rgb_to_xyb(rgb)))
    scaled = (torch.as_tensor(inv_global_scale, dtype=torch.float32,
                              device=dev)
              / qf.to(torch.float32))[:, :, None, None]
    dm_inv = torch.as_tensor(dm_inv, dtype=torch.float32, device=dev)
    dm_y = torch.as_tensor(dm_y, dtype=torch.float32, device=dev)
    qy = torch.round(co[1] * dm_inv[1] / scaled)
    dy = adjust_quant_bias(qy, 1) * dm_y * scaled
    qx = torch.round(co[0] * dm_inv[0] / (scaled * float(x_dm_mult)))
    qb = torch.round((co[2] - dy) * dm_inv[2] / (scaled * float(b_dm_mult)))
    q = torch.stack([qx, qy, qb]).to(torch.int32)
    # DC: the block means quantized, with CfL on B (base_b 1)
    idc = torch.as_tensor(inv_dc_quant_mul, dtype=torch.float32, device=dev)
    dc = co[:, :, :, 0, 0]
    qdc_y = torch.round(dc[1] * idc[1])
    qdc_x = torch.round(dc[0] * idc[0])
    qdc_b = torch.round((dc[2] - qdc_y / idc[1]) * idc[2])
    qdc = torch.stack([qdc_x, qdc_y, qdc_b]).to(torch.int32)
    q[:, :, :, 0, 0].fill_(0)  # a scalar store would upload it
    return q, qdc
