"""Butteraugli comparator as torch ops on the tensors' device.

The port of libjxl_tpu/metrics/butteraugli_jax.py, itself the device form
of the host comparator metrics/butteraugli.py (butteraugli/butteraugli.cc):
opsin dynamics, LF/MF/HF/UHF separation, 16-direction Malta filters,
psycho masking and the half-res pass. The constants and Malta tap
patterns are the host module's (they ARE the model).

The separable blurs are two products with a dense banded, row-normalised
matrix (B_y @ img @ B_x^T), fp32 with TF32 off (base/device.py), a
per-device constant of ops/programs.py per (n, sigma). The Malta filters
are shifted adds on a zero-padded plane, most of a diffmap's ~3,000
torch operations (a fused kernel is open perf work, ROADMAP section 2).

butteraugli_diffmap_torch is the "diffmap" program (ops/programs.py), at
the JAX package's static key (hf_asymmetry, xmul, intensity_target): on
a card its second call of one shape captures the whole map into a CUDA
graph, and later calls replay it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.device import apply_precision_policy
from ..ops import programs
from ..ops.pipeline import _fma
from .butteraugli import (
    MALTA_FULL,
    MALTA_LF,
    NORM1_HF,
    NORM1_HF_X,
    NORM1_MF,
    NORM1_MF_X,
    NORM1_UHF,
    NORM1_UHF_X,
    W_HF_MALTA,
    W_HF_MALTA_X,
    W_MF_MALTA,
    W_MF_MALTA_X,
    W_UHF_MALTA,
    W_UHF_MALTA_X,
    WMUL,
    _GLOBAL_SCALE,
    _gauss_kernel,
)


def _blur_matrix_np(n: int, sigma: float) -> np.ndarray:
    """Row-normalised banded Gaussian as a dense (n, n) matrix; row
    normalisation reproduces the host blur's border renormalisation."""
    k = _gauss_kernel(sigma)
    r = len(k) // 2
    b = np.zeros((n, n), dtype=np.float64)
    for j, wj in enumerate(k):
        d = j - r
        idx = np.arange(max(0, -d), min(n, n - d))
        b[idx, idx + d] += wj
    b /= b.sum(axis=1, keepdims=True)
    return b.astype(np.float32)


def _blur_matrix(n: int, sigma: float, device: torch.device) -> torch.Tensor:
    """_blur_matrix_np on `device` (n^2 f32: 16 MB at 2048), made once a
    device: a program's capture may not upload."""
    return programs.constant(f"butteraugli_blur_{n}_{sigma!r}", device,
                             lambda: _blur_matrix_np(n, sigma))


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable truncated-Gaussian blur with border renormalisation of
    the last two dims of f32[..., h, w]."""
    h, w = img.shape[-2:]
    by = _blur_matrix(h, sigma, img.device)
    bx = _blur_matrix(w, sigma, img.device)
    return torch.matmul(torch.matmul(by, img), bx.T)


def _opsin_absorbance(r, g, b, clamp):
    m = (0.29956550340058319, 0.63373087833825936, 0.077705617820981968,
         1.7557483643287353, 0.22158691104574774, 0.69391388044116142,
         0.0987313588422, 1.7557483643287353, 0.02, 0.02,
         0.20480129041026129, 12.226454707163354)
    # XLA's CPU form of the JAX package's multiply-adds (two fused
    # multiply-adds, then the bias): the X channel is a difference of two
    # of these, and an ulp here is 1e-4 of the diffmap
    o0, o1, o2 = (_fma(np.float32(m[i + 2]), b,
                       _fma(np.float32(m[i]), r, m[i + 1] * g)) + m[i + 3]
                  for i in (0, 4, 8))
    if clamp:
        o0 = torch.clamp_min(o0, m[3])
        o1 = torch.clamp_min(o1, m[7])
        o2 = torch.clamp_min(o2, m[11])
    return o0, o1, o2


def _gamma(v):
    return 19.245013259874995 * torch.log(torch.clamp_min(v, 0.0)
                                          + 9.9710635769299145) \
        - 23.16046239805755


def opsin_dynamics_image(rgb_linear: torch.Tensor,
                         intensity_target: float = 80.0) -> torch.Tensor:
    rgb = rgb_linear * intensity_target
    blurred = _blur(rgb, 1.2)
    pre = _opsin_absorbance(blurred[0], blurred[1], blurred[2], clamp=True)
    sens = []
    for p in pre:
        p = torch.clamp_min(p, 1e-4)
        sens.append(torch.clamp_min(_gamma(p) / p, 1e-4))
    cur = _opsin_absorbance(rgb[0], rgb[1], rgb[2], clamp=False)
    m0 = torch.clamp_min(cur[0] * sens[0], 1.7557483643287353)
    m1 = torch.clamp_min(cur[1] * sens[1], 1.7557483643287353)
    m2 = torch.clamp_min(cur[2] * sens[2], 12.226454707163354)
    return torch.stack([m0 - m1, m0 + m1, m2])


def _remove_range(x, w):
    return torch.where(x > w, x - w, torch.where(x < -w, x + w, 0.0))


def _amplify_range(x, w):
    return torch.where(x > w, x + w, torch.where(x < -w, x - w, 2.0 * x))


def _maximum_clamp(v, maxval):
    mul = 0.724216145665
    return torch.where(v >= maxval, (v - maxval) * mul + maxval,
                       torch.where(v < -maxval, (v + maxval) * mul - maxval,
                                   v))


def separate_frequencies(xyb: torch.Tensor):
    """-> (lf f32[3, h, w], mf f32[3, h, w], hf [x, y], uhf [x, y])."""
    sigma_lf, sigma_hf, sigma_uhf = 7.15593339443, 3.22489901262, \
        1.56416327805
    lf_b = _blur(xyb, sigma_lf)
    mf = list((xyb - lf_b).unbind(0))
    lx, ly, lb = lf_b.unbind(0)
    lf = torch.stack([lx * 33.832837186260, ly * 14.458268100570,
                      (lb - 0.362267051518 * ly) * 49.87984651440])
    blurred = _blur(torch.stack(mf), sigma_hf)
    hf = [mf[0] - blurred[0], mf[1] - blurred[1]]
    mf = [_remove_range(blurred[0], 0.29), _amplify_range(blurred[1], 0.1),
          blurred[2]]
    s = 0.653020556257
    scaler = s + (1.0 - s) * (46.0 / (hf[1] * hf[1] + 46.0))
    hf[0] = hf[0] * scaler
    blurred = _blur(torch.stack(hf), sigma_uhf)
    uhf = [_remove_range(hf[0] - blurred[0], 0.04),
           _maximum_clamp(hf[1] - blurred[1], 5.19175294647) * 2.69313763794]
    hf = [_remove_range(blurred[0], 1.5),
          _amplify_range(_maximum_clamp(blurred[1], 28.4691806922) * 2.155,
                         0.132)]
    return lf, torch.stack(mf), hf, uhf


def _malta_diffs(v0, v1, w_0gt1, w_0lt1, norm1, mulli):
    len_ = 3.75
    w_pre0gt1 = mulli * np.sqrt(0.5 * w_0gt1) / (len_ * 2 + 1)
    w_pre0lt1 = mulli * np.sqrt(0.33 * w_0lt1) / (len_ * 2 + 1)
    norm2_0gt1 = float(w_pre0gt1 * norm1)
    norm2_0lt1 = float(w_pre0lt1 * norm1)
    absval = 0.5 * (torch.abs(v0) + torch.abs(v1))
    diff = v0 - v1
    # a 0-d tensor over a tensor is a true division (a Python number over
    # a tensor is a reciprocal and a product in torch); torch.full writes
    # it on the device, where torch.tensor would upload it
    den = norm1 + absval
    scaler = torch.full((), norm2_0gt1, dtype=den.dtype,
                        device=den.device) / den
    diffs = scaler * diff
    scaler2 = torch.full((), norm2_0lt1, dtype=den.dtype,
                         device=den.device) / den
    fabs0 = torch.abs(v0)
    too_small = 0.55 * fabs0
    too_big = 1.05 * fabs0
    neg = v0 < 0
    impact_neg = torch.where(
        v1 > -too_small, scaler2 * (v1 + too_small),
        torch.where(v1 < -too_big, -(scaler2 * (-v1 - too_big)), 0.0))
    impact_pos = torch.where(
        v1 < too_small, scaler2 * (too_small - v1),
        torch.where(v1 > too_big, -(scaler2 * (v1 - too_big)), 0.0))
    return diffs + torch.where(neg, -impact_neg, impact_pos)


def _malta_filter(diffs: torch.Tensor, patterns) -> torch.Tensor:
    h, w = diffs.shape
    p = torch.nn.functional.pad(diffs, (4, 4, 4, 4))
    out = None
    for taps in patterns:
        acc = None
        for (dy, dx) in taps:
            t = p[4 + dy:4 + dy + h, 4 + dx:4 + dx + w]
            acc = t if acc is None else acc + t
        sq = acc * acc
        out = sq if out is None else out + sq
    return out


def _malta_diff_map(v0, v1, w_0gt1, w_0lt1, norm1, lf):
    mulli = 0.611612573796 if lf else 0.39905817637
    diffs = _malta_diffs(v0, v1, w_0gt1, w_0lt1, norm1, mulli)
    return _malta_filter(diffs, MALTA_LF if lf else MALTA_FULL)


def _fuzzy_erosion(src: torch.Tensor) -> torch.Tensor:
    """0.45 m0 + 0.3 min(m1, 2 m0) + 0.25 min(m2, 2 m0) of the 3 smallest
    of each pixel and its 8 neighbours at distance 3 (+inf outside)."""
    h, w = src.shape
    planes = torch.full((9, h, w), float("inf"), dtype=src.dtype,
                        device=src.device)
    planes[0] = src
    i = 1
    for dy in (-3, 0, 3):
        for dx in (-3, 0, 3):
            if dy == 0 and dx == 0:
                continue
            y0, y1 = max(0, -dy), min(h, h - dy)
            x0, x1 = max(0, -dx), min(w, w - dx)
            if y1 > y0 and x1 > x0:
                planes[i, y0:y1, x0:x1] = src[y0 + dy:y1 + dy,
                                              x0 + dx:x1 + dx]
            i += 1
    m0, m1, m2 = torch.topk(planes, 3, dim=0, largest=False,
                            sorted=True).values
    m1 = torch.minimum(m1, 2 * m0)
    m2 = torch.minimum(m2, 2 * m0)
    return 0.45 * m0 + 0.3 * m1 + 0.25 * m2


def _mask_psycho(hf0, uhf0, hf1, uhf1, block_diff_ac_y):
    def combine(hf, uhf):
        xdiff = (uhf[0] + hf[0]) * 2.5
        ydiff = uhf[1] * 0.4 + hf[1] * 0.4
        return torch.sqrt(xdiff * xdiff + ydiff * ydiff)

    def precompute(m):
        mul, bias = 6.19424080439, 12.61050594197
        b = mul * bias
        return torch.sqrt(mul * torch.abs(m) + b) - float(np.sqrt(b))

    blurred = _blur(torch.stack([precompute(combine(hf0, uhf0)),
                                 precompute(combine(hf1, uhf1))]), 2.7)
    d = blurred[0] - blurred[1]
    block_diff_ac_y = block_diff_ac_y + 10.0 * (d * d)
    return _fuzzy_erosion(blurred[0]), block_diff_ac_y


def _mask_y(delta):
    c = 2.5485944793 / (0.451936922203 * delta + 0.829591754942)
    r = _GLOBAL_SCALE * (1.0 + c)
    return r * r


def _mask_dc_y(delta):
    c = 0.505054525019 / (3.87449418804 * delta + 0.20025578522)
    r = _GLOBAL_SCALE * (1.0 + c)
    return r * r


def _diffmap_full(xyb0, xyb1, hf_asymmetry, xmul):
    lf0, mf0, hf0, uhf0 = separate_frequencies(xyb0)
    lf1, mf1, hf1, uhf1 = separate_frequencies(xyb1)
    sq = float(np.sqrt(hf_asymmetry))
    ac = [None, None, None]
    ac[1] = _malta_diff_map(uhf0[1], uhf1[1], W_UHF_MALTA * hf_asymmetry,
                            W_UHF_MALTA / hf_asymmetry, NORM1_UHF,
                            lf=False)
    ac[0] = _malta_diff_map(uhf0[0], uhf1[0], W_UHF_MALTA_X * hf_asymmetry,
                            W_UHF_MALTA_X / hf_asymmetry, NORM1_UHF_X,
                            lf=False)
    ac[1] = ac[1] + _malta_diff_map(hf0[1], hf1[1], W_HF_MALTA * sq,
                                    W_HF_MALTA / sq, NORM1_HF, lf=True)
    ac[0] = ac[0] + _malta_diff_map(hf0[0], hf1[0], W_HF_MALTA_X * sq,
                                    W_HF_MALTA_X / sq, NORM1_HF_X,
                                    lf=True)
    ac[1] = ac[1] + _malta_diff_map(mf0[1], mf1[1], W_MF_MALTA, W_MF_MALTA,
                                    NORM1_MF, lf=True)
    ac[0] = ac[0] + _malta_diff_map(mf0[0], mf1[0], W_MF_MALTA_X,
                                    W_MF_MALTA_X, NORM1_MF_X, lf=True)
    ac[2] = torch.zeros_like(ac[0])
    dc = [None, None, None]
    for c in range(3):
        if c < 2:
            d = hf0[c] - hf1[c]
            total = d * d * (WMUL[c] * hf_asymmetry * 0.8)
            fabs0 = torch.abs(hf0[c])
            too_small = 0.4 * fabs0
            too_big = fabs0
            v = torch.where(
                hf0[c] < 0,
                torch.where(hf1[c] > -too_small, hf1[c] + too_small,
                            torch.where(hf1[c] < -too_big,
                                        -hf1[c] - too_big, 0.0)),
                torch.where(hf1[c] < too_small, too_small - hf1[c],
                            torch.where(hf1[c] > too_big,
                                        hf1[c] - too_big, 0.0)))
            ac[c] = ac[c] + total + (WMUL[c] / hf_asymmetry * 0.8) * v * v
        m = mf0[c] - mf1[c]
        ac[c] = ac[c] + WMUL[3 + c] * (m * m)
        d = lf0[c] - lf1[c]
        dc[c] = WMUL[6 + c] * (d * d)
    mask, ac[1] = _mask_psycho(hf0, uhf0, hf1, uhf1, ac[1])
    my = _mask_y(mask)
    mdc = _mask_dc_y(mask)
    dsum = (dc[0] * xmul + dc[1] + dc[2]) * mdc
    asum = (ac[0] * xmul + ac[1] + ac[2]) * my
    return torch.sqrt(torch.clamp_min(dsum + asum, 0.0))


def _subsample2x(rgb: torch.Tensor) -> torch.Tensor:
    """2x2 box average, the last row and column repeated on odd sides."""
    _, h, w = rgb.shape
    hh, ww = (h + 1) // 2, (w + 1) // 2
    iy = torch.clamp_max(torch.arange(hh * 2, device=rgb.device), h - 1)
    ix = torch.clamp_max(torch.arange(ww * 2, device=rgb.device), w - 1)
    ext = rgb.index_select(1, iy).index_select(2, ix)
    return 0.25 * (ext[:, 0::2, 0::2] + ext[:, 1::2, 0::2]
                   + ext[:, 0::2, 1::2] + ext[:, 1::2, 1::2])


def butteraugli_diffmap_torch(rgb0_linear, rgb1_linear,
                              hf_asymmetry: float = 0.8, xmul: float = 1.0,
                              intensity_target: float = 80.0) -> torch.Tensor:
    """Per-pixel diffmap f32[H, W] of two linear RGB (3, H, W) images in
    [0, 1] (tensors or numpy arrays), incl. the half-res pass, on the
    first image's device: the "diffmap" program (module docstring)."""
    dev = rgb0_linear.device if isinstance(rgb0_linear, torch.Tensor) \
        else torch.device("cpu")
    return programs.run(
        "diffmap", (hf_asymmetry, xmul, intensity_target), _diffmap,
        rgb0_linear, rgb1_linear, hf_asymmetry=hf_asymmetry, xmul=xmul,
        intensity_target=intensity_target, device=dev)


def _diffmap(rgb0_linear, rgb1_linear, hf_asymmetry, xmul,
             intensity_target):
    """The diffmap program's body: butteraugli_diffmap_jax in torch ops
    on the first image's device."""
    apply_precision_policy()
    rgb0 = rgb0_linear.to(torch.float32)
    rgb1 = rgb1_linear.to(device=rgb0.device, dtype=torch.float32)
    h, w = rgb0.shape[1:]
    xyb0 = opsin_dynamics_image(rgb0, intensity_target)
    xyb1 = opsin_dynamics_image(rgb1, intensity_target)
    diffmap = _diffmap_full(xyb0, xyb1, hf_asymmetry, xmul)
    if min(h, w) >= 16:
        s0 = opsin_dynamics_image(_subsample2x(rgb0), intensity_target)
        s1 = opsin_dynamics_image(_subsample2x(rgb1), intensity_target)
        sub = _diffmap_full(s0, s1, hf_asymmetry, xmul)
        up = sub.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]
        diffmap = diffmap * (1.0 - 0.3 * 0.5) + 0.5 * up
    return diffmap


def butteraugli_score_torch(rgb0_linear, rgb1_linear,
                            hf_asymmetry: float = 0.8,
                            intensity_target: float = 80.0) -> float:
    """Butteraugli distance: the max of the diffmap (0 below 8 px)."""
    if min(rgb0_linear.shape[1:]) < 8:
        return 0.0
    dm = butteraugli_diffmap_torch(rgb0_linear, rgb1_linear,
                                   hf_asymmetry=hf_asymmetry,
                                   intensity_target=intensity_target)
    return float(dm.max())
