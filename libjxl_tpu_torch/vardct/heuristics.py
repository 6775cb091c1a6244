"""Encoder heuristics: inverse Gaborish, adaptive quant field, CfL fitting.

- gaborish_inverse mirrors enc_gaborish.cc:21-49 (symmetric-5x5 sharpen
  whose coefficients were butteraugli-optimized in the reference; they are
  format-relevant only through rate/distortion, not bitstream legality).
- initial_quant_field is a vectorized reformulation of
  enc_adaptive_quantization.cc InitialQuantField: per-block masking from
  local activity of the Y channel. The reference's full Butteraugli
  feedback loop (FindBestQuantization) hooks in at higher efforts.
- fit_cfl mirrors CfLHeuristics (enc_chroma_from_luma.cc): per 64x64 tile
  least-squares of X (and B-Y) against Y in the DCT-coefficient domain.
"""

from __future__ import annotations

import numpy as np

from .ctx import QUANT_MAX

# kGaborish (enc_gaborish.cc:30-33)
_K_GABORISH = (-0.09495815671340026, -0.041031725066768575,
               0.013710004822696948, 0.006510206083837737,
               -0.0014789063378272242)


def gaborish_inverse_kernel(mul: float = 1.0) -> np.ndarray:
    """5x5 sharpen kernel approximating the inverse of the decoder's 3x3
    Gaborish blur."""
    k0, k1, k2, k3, k4 = _K_GABORISH
    s = 1.0 + mul * 4 * (k0 + k1 + k2 + k4 + 2 * k3)
    s = max(s, 1e-5)
    norm = 1.0 / s
    m = mul * norm
    kern = np.zeros((5, 5))
    kern[2, 2] = norm
    for (dy, dx), w in (
        (((0, 1)), k0), ((1, 1), k1), ((0, 2), k2), ((1, 2), k3),
            ((2, 2), k4)):
        positions = set()
        for sy in (-1, 1):
            for sx in (-1, 1):
                positions.add((2 + sy * dy, 2 + sx * dx))
                positions.add((2 + sy * dx, 2 + sx * dy))
        for (y, x) in positions:
            kern[y, x] = m * w
    return kern


def apply_gaborish_inverse(xyb: np.ndarray) -> np.ndarray:
    """Sharpen all three channels with the inverse kernel (edge padding).

    One C stencil pass per channel (scipy.ndimage, mode='reflect' ==
    symmetric edge padding) instead of 21 full-image numpy temporaries.
    """
    from scipy import ndimage

    kern = gaborish_inverse_kernel(1.0)
    out = np.empty_like(xyb)
    for c in range(3):
        ndimage.correlate(xyb[c], kern, output=out[c], mode="reflect")
    return out


def initial_quant_field(y: np.ndarray, nby: int, nbx: int, distance: float,
                        base_quant: float) -> np.ndarray:
    """Per-block quant multipliers from local Y-channel activity.

    Smooth blocks (low gradient energy) get higher quant (finer steps are
    perceptually needed there is inverted in JXL convention: raw_quant is a
    *multiplier*, higher = finer). Busy blocks mask errors -> lower quant.
    Returns int32 (nby, nbx) raw quant field values.
    """
    h, w = nby * 8, nbx * 8
    yp = y[:h, :w]
    gy = np.abs(np.diff(yp, axis=0, prepend=yp[:1]))
    gx = np.abs(np.diff(yp, axis=1, prepend=yp[:, :1]))
    grad = (gy + gx).reshape(nby, 8, nbx, 8).mean(axis=(1, 3))
    # masking: log-domain modulation around the base quant
    act = np.log1p(grad * 80.0)
    mod = np.clip(1.6 - 0.35 * act, 0.55, 1.8)
    qf = np.clip(np.round(base_quant * mod), 1, QUANT_MAX)
    return qf.astype(np.int32)


def epf_sharpness_field(y: np.ndarray, nby: int, nbx: int) -> np.ndarray:
    """Per-block EPF sharpness (ComputeARHeuristics,
    enc_heuristics.cc:890-930): the reference fills a uniform 4 except
    at slower-than-wombat tiers, where a per-value reconstruction
    search picks block minima. We match the default; the search is a
    possible slow-tier extension. (An A/B against an activity-derived
    field measured within noise of uniform 4.)"""
    _ = y
    return np.full((nby, nbx), 4, dtype=np.int32)


def refine_quant_field(state, xyb_sharp: np.ndarray, xyb_orig: np.ndarray,
                       distance: float, iters: int = 2, device=None) -> None:
    """Butteraugli-feedback quant refinement (FindBestQuantization,
    enc_adaptive_quantization.cc:934, <= 4 iters at kitten+).

    Each round: trial-quantize the DCT8 grid with the current field,
    reconstruct the decoder's view (dequant + IDCT + Gaborish blur when
    the frame enables it), compute the perceptual diffmap against the
    pre-sharpening original, and scale each block's raw quant value
    toward the target distance. Operates on state.raw_quant_field in
    place; runs before the AC-strategy search (the refined field feeds
    both the search and the final coefficients).

    device: a torch device runs each round's trial and diffmap there
    (_refine_device) when both sides are at least 32 px; None, or a
    smaller frame, runs the host loop."""
    from ..metrics.distance import butteraugli_diffmap_xyb
    from ..ops.dct import fwd_matrix, inv_matrix
    from ..render.pipeline import gaborish_kernel

    fd = state.fd
    nby, nbx = fd.ysize_blocks, fd.xsize_blocks
    inv_gs = state.quantizer.inv_global_scale
    kind = 0  # DCT8 proxy grid
    dm = np.stack([state.matrices.dequant_matrix(kind, c)
                   for c in range(3)])
    dm_inv = np.stack([state.matrices.inv_matrix(kind, c)
                       for c in range(3)])
    f8, i8 = fwd_matrix(8), inv_matrix(8)
    blocks = xyb_sharp.reshape(3, nby, 8, nbx, 8).transpose(0, 1, 3, 2, 4)
    co = np.einsum("ur,cnmrk,vk->cnmuv", f8, blocks, f8,
                   optimize=True)
    dc = co[:, :, :, 0, 0].copy()
    gab = None
    if state.fh.loop_filter.gab:
        lf = state.fh.loop_filter
        gab = [gaborish_kernel(getattr(lf, f"gab_{ch}_weight1"),
                               getattr(lf, f"gab_{ch}_weight2"))
               for ch in "xyb"]
    lf = state.fh.loop_filter
    epf_iters = lf.epf_iters
    # with the decoder view including Gaborish AND EPF the proxy error
    # matches the real decode closely. `distance` here is the INTERNAL
    # (0.7x-calibrated) value; a target of internal * 1.4 (~ the public
    # distance on our comparator's scale) sits below the typical
    # delivered block maxima, so the one-sided loop lifts the worst
    # blocks toward the requested distance (e7's "consistency" role,
    # doc/encode_effort.md)
    target = max(distance, 0.05) * 1.4
    qf_float = state.raw_quant_field.astype(np.float64)
    if device is not None and min(nby * 8, nbx * 8) >= 32:
        _refine_device(state, co, dc, dm, dm_inv, inv_gs, gab, lf,
                       xyb_orig, qf_float, target, iters, nby, nbx, device)
        return
    for _ in range(iters):
        scaled = (inv_gs / np.maximum(np.round(qf_float), 1.0))[
            None, :, :, None, None]
        q = np.round(co * dm_inv[:, None, None] / scaled)
        rec = q * dm[:, None, None] * scaled
        rec[:, :, :, 0, 0] = dc  # DC coded separately (finer)
        pix = np.einsum("ru,cnmuv,kv->cnrmk", i8, rec, i8,
                    optimize=True).reshape(
            3, nby * 8, nbx * 8)
        if gab is not None:
            pad = np.pad(pix, ((0, 0), (1, 1), (1, 1)), mode="symmetric")
            blurred = np.zeros_like(pix)
            for c in range(3):
                for dy in range(3):
                    for dx in range(3):
                        w = gab[c][dy, dx]
                        if w:
                            blurred[c] += w * pad[c, dy:dy + pix.shape[1],
                                                  dx:dx + pix.shape[2]]
            pix = blurred
        if epf_iters > 0:
            # the decoder's edge-preserving filter smooths quantization
            # error; without it the proxy overestimates and the loop
            # overspends (stage_epf analog, VERDICT round-1 weak #4)
            from ..render.pipeline import apply_epf, compute_sigma

            inv_sigma = compute_sigma(
                lf, state.quantizer.global_scale_float,
                np.maximum(np.round(qf_float), 1.0).astype(np.int32),
                state.epf_sharpness)
            pix = apply_epf(pix, lf, inv_sigma)
        dmap = _perceptual_diffmap(pix, xyb_orig)
        # per-block MAX: the reported butteraugli distance is a
        # max-dominated norm, so the loop must chase block maxima —
        # a mean blend under-reads exactly the blocks that set the score
        berr = dmap.reshape(nby, 8, nbx, 8).max(axis=(1, 3))
        qf_float = np.clip(qf_float * _refine_ratio(berr, target),
                           1.0, QUANT_MAX)
    state.raw_quant_field = np.clip(
        np.round(qf_float), 1, QUANT_MAX).astype(np.int32)


def _refine_ratio(berr: np.ndarray, target: float) -> np.ndarray:
    """Per-block quant update factor for one refinement round.

    Tightening side: blocks whose proxy error exceeds the target get a
    finer quantizer (FindBestQuantization's damage-chasing updates,
    enc_adaptive_quantization.cc:934-1010). Relaxing side: blocks
    reading FAR below the target (< 0.4x) release rate, bounded at
    0.8x per round — gated that low because the per-block proxy
    under-reads the global max norm on textured content, and relaxing
    a block that actually contributes to the max degrades the
    delivered score (measured: an ungated 0.7 floor cost texture
    +0.35 BA; the 0.4x gate leaves texture untouched while cutting
    screenshot/smooth sizes ~20%, judged by the REFERENCE comparator —
    docs/BUTTERAUGLI_ANCHOR.md section 2)."""
    r = (berr / target) ** 0.5
    ratio = np.clip(r, 1.0, 1.6)
    return np.where(berr < 0.4 * target, np.maximum(r, 0.8), ratio)


def _trial(co, dc, qfr, dm, dm_inv, igs, i8, gab, inv_sigma, sad_mul,
           channel_scale, pass0_sigma_scale, pass2_sigma_scale, epf_iters):
    """The decoder's view of the DCT8 grid under the field qfr, on co's
    device: quantize, dequantize, insert the DC, IDCT8 (the non-transposed
    (u, v) layout of the host proxy's forward transform), then Gaborish
    (gab f32[3, 3, 3], or None) and the EPF chain through
    kernels.render_tail (inv_sigma per block), XYB -> linear RGB clipped
    to [0, 1]. co f32[3, nby, nbx, 8, 8], dc f32[3, nby, nbx], qfr and
    inv_sigma f32[nby, nbx], dm and dm_inv f32[3, 8, 8], igs a 0-d f32
    tensor."""
    import torch

    from ..ops import kernels
    from ..ops.pipeline import blocks_to_image, xyb_to_rgb

    scaled = (igs / qfr)[None, :, :, None, None]
    q = torch.round(co * dm_inv[:, None, None] / scaled)
    rec = q * dm[:, None, None] * scaled
    rec[:, :, :, 0, 0] = dc
    pix = torch.einsum("ru,cnmuv,kv->cnmrk", i8, rec, i8)
    img = blocks_to_image(pix).contiguous()
    if gab is not None or epf_iters:
        img = kernels.render_tail(img, gab, inv_sigma, sad_mul,
                                  channel_scale, epf_iters,
                                  pass0_sigma_scale, pass2_sigma_scale,
                                  out="xyb")
    return torch.clamp(xyb_to_rgb(img), 0.0, 1.0)


def _refine_device(state, co, dc, dm, dm_inv, inv_gs, gab, lf, xyb_orig,
                   qf_float, target, iters, nby, nbx, device):
    """Torch body of refine_quant_field on `device`: each round's trial
    (the "trial" program, _trial with one render_tail launch when the
    frame has Gaborish or EPF, at the JAX package's static key (gab_on,
    epf_iters)) and butteraugli diffmap (the "diffmap" program) run
    there, the trial's image going from the one program's output to the
    other's input on the device, and the per-block maxima come back; only
    the field update (_refine_ratio) runs on the host."""
    from ..metrics.butteraugli_torch import butteraugli_diffmap_torch
    from ..ops import programs
    from ..ops.dct import inv_matrix
    from ..ops.staging import f32, sad_mul, to_device
    from ..ops.xyb import xyb_to_linear_rgb
    from ..render.pipeline import compute_sigma

    h, w = nby * 8, nbx * 8
    epf_iters = int(lf.epf_iters)
    co_t, dc_t, dm_t, dmi_t, i8, lin_orig = to_device(tuple(
        a.astype(np.float32) for a in (
            co, dc, dm, dm_inv, inv_matrix(8),
            np.clip(xyb_to_linear_rgb(xyb_orig), 0.0, 1.0))), device)
    gab_t = None if gab is None \
        else to_device(np.stack(gab).astype(np.float32), device)
    sad = to_device(sad_mul(lf, h, w), device) if epf_iters else None
    cs = tuple(f32(v) for v in lf.epf_channel_scale)
    igs = np.asarray(inv_gs, dtype=np.float32)
    for _ in range(iters):
        qfr = np.maximum(np.round(qf_float), 1.0).astype(np.float32)
        isg = None
        if epf_iters:
            isg = compute_sigma(
                lf, state.quantizer.global_scale_float,
                qfr.astype(np.int32), state.epf_sharpness).astype(
                    np.float32)
        lin = programs.run(
            "trial", (gab is not None, epf_iters), _trial, co_t, dc_t, qfr,
            dm_t, dmi_t, igs, i8, gab_t, isg, sad, cs,
            f32(lf.epf_pass0_sigma_scale), f32(lf.epf_pass2_sigma_scale),
            epf_iters, device=device)
        dmap = butteraugli_diffmap_torch(lin, lin_orig)
        berr = dmap.reshape(nby, 8, nbx, 8).amax(dim=(1, 3)).cpu().numpy()
        qf_float = np.clip(qf_float * _refine_ratio(berr, target),
                           1.0, QUANT_MAX)
    state.raw_quant_field = np.clip(
        np.round(qf_float), 1, QUANT_MAX).astype(np.int32)


def _perceptual_diffmap(xyb_a: np.ndarray, xyb_b: np.ndarray) -> np.ndarray:
    """Diffmap for the quant-feedback loop: the faithful butteraugli
    model on images large enough for its frequency separation, else the
    fast approximate XYB comparator."""
    if min(xyb_a.shape[1:]) >= 32:
        from ..ops.xyb import xyb_to_linear_rgb

        lin_a = np.clip(xyb_to_linear_rgb(xyb_a), 0.0, 1.0)
        lin_b = np.clip(xyb_to_linear_rgb(xyb_b), 0.0, 1.0)
        from ..metrics.butteraugli import butteraugli_diffmap

        return butteraugli_diffmap(lin_a, lin_b)
    from ..metrics.distance import butteraugli_diffmap_xyb

    return butteraugli_diffmap_xyb(xyb_a, xyb_b)


def fit_cfl(coeffs_x: np.ndarray, coeffs_y: np.ndarray, coeffs_b: np.ndarray,
            nby: int, nbx: int, color_factor: int = 84,
            base_b: float = 1.0):
    """Least-squares per-64x64-tile CfL factors in the coefficient domain.

    coeffs_*: (nby, nbx, 8, 8) dequantization-domain DCT coefficients (AC
    only considered; LLF ignored). Returns (ytox_map, ytob_map) int32 maps
    of shape (ceil(nby/8), ceil(nbx/8)) with values in [-128, 127].
    """
    tby, tbx = -(-nby // 8), -(-nbx // 8)
    ytox = np.zeros((tby, tbx), dtype=np.int32)
    ytob = np.zeros((tby, tbx), dtype=np.int32)
    mask = np.ones((8, 8), dtype=bool)
    mask[0, 0] = False  # exclude LLF
    for ty in range(tby):
        for tx in range(tbx):
            sl = (slice(ty * 8, min((ty + 1) * 8, nby)),
                  slice(tx * 8, min((tx + 1) * 8, nbx)))
            ys = coeffs_y[sl][..., mask].reshape(-1)
            xs = coeffs_x[sl][..., mask].reshape(-1)
            bs = coeffs_b[sl][..., mask].reshape(-1)
            denom = float(np.dot(ys, ys)) + 1e-9
            rx = float(np.dot(xs, ys)) / denom
            rb = float(np.dot(bs, ys)) / denom
            ytox[ty, tx] = int(np.clip(round(rx * color_factor), -128, 127))
            ytob[ty, tx] = int(np.clip(
                round((rb - base_b) * color_factor), -128, 127))
    return ytox, ytob


# --- full InitialQuantField port (enc_adaptive_quantization.cc) ---

_SG_MUL = 226.77216153508914
_SG_MUL2 = 1.0 / 73.377132366608819
_LOG2 = 0.693147181
_SG_RETMUL = _SG_MUL2 * 18.6580932135 * _LOG2
_SG_VOFFSET = 7.7825991679894591


def _ratio_cbrt_gamma(v: np.ndarray, invert: bool = False) -> np.ndarray:
    """RatioOfDerivativesOfCubicRootToSimpleGamma
    (enc_adaptive_quantization.cc:118-137)."""
    eps = 1e-2
    v = np.maximum(v, 0.0)
    num = (_SG_RETMUL * 3 * _SG_MUL) * v * v + eps
    den = (_LOG2 * _SG_MUL) * v * v * v + (_SG_VOFFSET * _LOG2 + eps)
    return num / den if invert else den / num


def _masking_sqrt(v: np.ndarray) -> np.ndarray:
    k_log_offset = 27.505837037000106
    k_mul = 211.66567973503678
    return 0.25 * np.sqrt(v * np.sqrt(k_mul * 1e8) + k_log_offset)


def _compute_mask(v: np.ndarray) -> np.ndarray:
    """ComputeMask rational polynomial (:85-101)."""
    v1 = np.maximum(v * 0.80061762862741759, 1e-3)
    v2 = 1.0 / (v1 + 302.59587815579727)
    v3 = 1.0 / (v1 * v1 + 3.7179635626140772)
    v4 = 1.0 / (v1 * v1 + 0.25 * 3.7179635626140772)
    return (-0.7647 + 9.4708735624378946 * v4 + 17.35036561631863 * v2
            + 6.7943250517376494 * v3)


def _block_sum(img: np.ndarray, nby: int, nbx: int) -> np.ndarray:
    return img[:nby * 8, :nbx * 8].reshape(nby, 8, nbx, 8).sum(axis=(1, 3))


def initial_quant_field_full(xyb: np.ndarray, nby: int, nbx: int,
                             distance: float,
                             rescale: float = 1.0) -> np.ndarray:
    """Float per-block quant field (AdaptiveQuantizationMap,
    enc_adaptive_quantization.cc:480-660 + PerBlockModulations
    :306-340), vectorized. xyb: (3, H, W) opsin planes."""
    quant_ac = 0.725 / max(distance, 1e-3)  # kAcQuant (:843)
    scale = quant_ac * rescale
    h, w = nby * 8, nbx * 8
    yp = xyb[1][:h, :w]
    xp = xyb[0][:h, :w]
    bp = xyb[2][:h, :w]

    # per-pixel masking diff (:510-600)
    p = np.pad(yp, 1, mode="edge")
    base = 0.25 * (p[2:, 1:-1] + p[:-2, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])
    gammac = _ratio_cbrt_gamma(yp + 0.019)
    diff = np.minimum((gammac * (yp - base)) ** 2, 0.2)
    diff = _masking_sqrt(diff)
    # 4x4 cell aggregation * 0.25 -> pre_erosion at half-block res
    pre = diff.reshape(h // 4, 4, w // 4, 4).sum(axis=(1, 3)) * 0.25

    # FuzzyErosion (:380-450): weighted 4 smallest of the 9-neighborhood
    mul = max(0.0, min(1.0, (2.0 - distance) / 2.0)) if distance < 2.0 \
        else 0.0
    k = np.array([0.125 + mul * 0.0, 0.10 - mul * 0.10,
                  0.09 - mul * 0.09, 0.06 - mul * 0.06])
    k *= 0.29959705784054957 / k.sum()
    pp = np.pad(pre, 1, mode="edge")
    hh, ww = pre.shape
    neigh = np.stack([pp[1 + dy:1 + dy + hh, 1 + dx:1 + dx + ww]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    # full sort of the 4 smallest: np.partition leaves slots 0-2 in
    # arbitrary order while the weights k[0..3] differ per rank
    part = np.sort(neigh, axis=0)
    eroded = (k[0] * part[0] + k[1] * part[1] + k[2] * part[2]
              + k[3] * part[3])
    # sum the four half-block cells into each block
    aq = eroded.reshape(nby, 2, nbx, 2).sum(axis=(1, 3))

    out = _compute_mask(aq)

    # HfModulation (:251-300): capped |gradient| sums over the block.
    # Only INTRA-block diffs count: the reference masks the rightmost
    # column's horizontal diff (kMaskRight) and uses the same row for
    # dy == 7, so diffs never cross the 8px block boundary.
    vmin = 0.0206
    dx_ = np.minimum(np.abs(yp[:, 1:] - yp[:, :-1]), vmin)
    dy_ = np.minimum(np.abs(yp[1:, :] - yp[:-1, :]), vmin)
    dx_ = np.pad(dx_, ((0, 0), (0, 1)))
    dy_ = np.pad(dy_, ((0, 1), (0, 0)))
    dx_[:, 7::8] = 0.0
    dy_[7::8, :] = 0.0
    hf = _block_sum(dx_, nby, nbx) + _block_sum(dy_, nby, nbx)
    out = out + hf * -0.38 + 0.42

    # GammaModulation (:170-200)
    r = _ratio_cbrt_gamma(yp + 0.16 - xp, invert=True)
    g = _ratio_cbrt_gamma(yp + 0.16 + xp, invert=True)
    overall = (_block_sum(r, nby, nbx) + _block_sum(g, nby, nbx)) \
        * (0.5 / 64)
    out = out + 0.1005613337192697 * np.log2(np.maximum(overall, 1e-9))

    # BlueModulation (:200-250)
    k_limit = 0.027121074570634722
    k_offset = 0.084381641171960495
    p_y_eff = bp - (yp + k_offset + np.abs(xp))
    contrib = np.where(p_y_eff > 0, np.minimum(p_y_eff, k_limit), 0.0)
    s = _block_sum(contrib, nby, nbx)
    s = np.where(s >= 32 * k_limit, 64 * k_limit - s, s)
    s = np.minimum(s, 15.398788439047934 * k_limit)
    out = out + s * 0.14207000358439159

    # final mapping (:330-340): exp with distance-dependent dampening
    base_level = 0.48 * scale
    if distance >= 2.0:
        dampen = max(0.0, 1.0 - (distance - 2.0) / 12.0)
    else:
        dampen = 1.0
    return np.exp(out) * (scale * dampen) + (1.0 - dampen) * base_level
