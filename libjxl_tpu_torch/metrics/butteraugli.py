"""Butteraugli psychovisual comparator (butteraugli/butteraugli.cc).

Faithful vectorized reimplementation of the reference model:
opsin dynamics (photopsin absorbance + adaptive gamma sensitivity),
LF/MF/HF/UHF frequency separation with the reference's range shaping,
16-direction Malta line-filter difference maps, psychovisual masking
(DiffPrecompute + FuzzyErosion), per-channel diff combination through
MaskY/MaskDcY, and the half-resolution supersampled pass. Score is the
maximum of the diffmap (ButteraugliScoreFromDiffmap).

Constants are transcribed from the reference; the Gaussian blur is the
same truncated FIR kernel (m = 2.25) with border renormalization.
"""

from __future__ import annotations

import functools

import numpy as np

# 16 directional line kernels, (dy, dx) taps (MaltaUnit,
# butteraugli.cc:577-947)
MALTA_LF = [[(0, -4), (0, -2), (0, 0), (0, 2), (0, 4)], [(-4, 0), (-2, 0), (0, 0), (2, 0), (4, 0)], [(-3, -3), (-2, -2), (0, 0), (2, 2), (3, 3)], [(-3, 3), (-2, 2), (0, 0), (2, -2), (3, -3)], [(-4, 1), (-2, 1), (0, 0), (2, -1), (4, -1)], [(-4, -1), (-2, -1), (0, 0), (2, 1), (4, 1)], [(-1, -4), (-1, -2), (0, 0), (1, 2), (1, 4)], [(1, -4), (1, -2), (0, 0), (-1, 2), (-1, 4)], [(-3, -2), (-2, -1), (0, 0), (2, 1), (3, 2)], [(-3, 2), (-2, 1), (0, 0), (2, -1), (3, -2)], [(-2, -3), (-1, -2), (0, 0), (1, 2), (2, 3)], [(-2, 3), (-1, 2), (0, 0), (1, -2), (2, -3)], [(2, -4), (1, -2), (0, 0), (-1, 2), (-2, 4)], [(-2, -4), (-1, -2), (0, 0), (1, 2), (2, 4)], [(-4, -2), (-2, -1), (0, 0), (2, 1), (4, 2)], [(-4, 2), (-2, 1), (0, 0), (2, -1), (4, -2)]]

MALTA_FULL = [[(0, -4), (0, -3), (0, -2), (0, -1), (0, 0), (0, 1), (0, 2), (0, 3), (0, 4)], [(-4, 0), (-3, 0), (-2, 0), (-1, 0), (0, 0), (1, 0), (2, 0), (3, 0), (4, 0)], [(-3, -3), (-2, -2), (-1, -1), (0, 0), (1, 1), (2, 2), (3, 3)], [(-3, 3), (-2, 2), (-1, 1), (0, 0), (1, -1), (2, -2), (3, -3)], [(-4, 1), (-3, 1), (-2, 1), (-1, 0), (0, 0), (1, 0), (2, -1), (3, -1), (4, -1)], [(-4, -1), (-3, -1), (-2, -1), (-1, 0), (0, 0), (1, 0), (2, 1), (3, 1), (4, 1)], [(-1, -4), (-1, -3), (-1, -2), (0, -1), (0, 0), (0, 1), (1, 2), (1, 3), (1, 4)], [(1, -4), (1, -3), (1, -2), (0, -1), (0, 0), (0, 1), (-1, 2), (-1, 3), (-1, 4)], [(-3, -2), (-2, -1), (-1, -1), (0, 0), (1, 1), (2, 1), (3, 2)], [(-3, 2), (-2, 1), (-1, 1), (0, 0), (1, -1), (2, -1), (3, -2)], [(-2, -3), (-1, -2), (-1, -1), (0, 0), (1, 1), (1, 2), (2, 3)], [(-2, 3), (-1, 2), (-1, 1), (0, 0), (1, -1), (1, -2), (2, -3)], [(1, -4), (1, -3), (1, -2), (0, -1), (0, 0), (0, 1), (-1, 2), (-1, 3), (-1, 4)], [(-1, -4), (-1, -3), (-1, -2), (0, -1), (0, 0), (0, 1), (1, 2), (1, 3), (1, 4)], [(-4, -1), (-3, -1), (-2, -1), (-1, 0), (0, 0), (1, 0), (2, 1), (3, 1), (4, 1)], [(-4, 1), (-3, 1), (-2, 1), (-1, 0), (0, 0), (1, 0), (2, -1), (3, -1), (4, -1)]]

# frequency weights (butteraugli.cc:57-74)
W_MF_MALTA = 37.0819870399
NORM1_MF = 130262059.556
W_MF_MALTA_X = 8246.75321353
NORM1_MF_X = 1009002.70582
W_HF_MALTA = 18.7237414387
NORM1_HF = 4498534.45232
W_HF_MALTA_X = 6923.99476109
NORM1_HF_X = 8051.15833247
W_UHF_MALTA = 1.10039032555
NORM1_UHF = 71.7800275169
W_UHF_MALTA_X = 173.5
NORM1_UHF_X = 5.0
WMUL = (400.0, 1.50815703118, 0.0,
        2150.0, 10.6195433239, 16.2176043152,
        29.2353797994, 0.844626970982, 0.703646627719)

_GLOBAL_SCALE = 1.0 / (17.83 * 0.79079917404)


@functools.lru_cache(maxsize=None)
def _gauss_kernel(sigma: float):
    m = 2.25
    diff = max(1, int(m * abs(sigma)))
    i = np.arange(-diff, diff + 1)
    return np.exp(-1.0 / (2 * sigma * sigma) * i * i)


def _blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable truncated-Gaussian blur with border renormalization
    (Blur + ConvolutionWithTranspose, butteraugli.cc:85-260)."""
    k = _gauss_kernel(sigma)
    r = len(k) // 2

    def axis0(x):
        h = x.shape[0]
        acc = np.zeros_like(x)
        wsum = np.zeros((h, 1))
        for j, w in enumerate(k):
            dy = j - r
            y0, y1 = max(0, -dy), min(h, h - dy)
            acc[y0:y1] += w * x[y0 + dy:y1 + dy]
            wsum[y0:y1] += w
        return acc / wsum

    return axis0(axis0(img).T).T


def _opsin_absorbance(r, g, b, clamp):
    m = (0.29956550340058319, 0.63373087833825936, 0.077705617820981968,
         1.7557483643287353, 0.22158691104574774, 0.69391388044116142,
         0.0987313588422, 1.7557483643287353, 0.02, 0.02,
         0.20480129041026129, 12.226454707163354)
    o0 = m[0] * r + m[1] * g + m[2] * b + m[3]
    o1 = m[4] * r + m[5] * g + m[6] * b + m[7]
    o2 = m[8] * r + m[9] * g + m[10] * b + m[11]
    if clamp:
        o0 = np.maximum(o0, m[3])
        o1 = np.maximum(o1, m[7])
        o2 = np.maximum(o2, m[11])
    return o0, o1, o2


def _gamma(v):
    return 19.245013259874995 * np.log(np.maximum(v, 0.0)
                                       + 9.9710635769299145)         - 23.16046239805755


def opsin_dynamics_image(rgb_linear: np.ndarray,
                         intensity_target: float = 80.0) -> np.ndarray:
    """Linear RGB (3, H, W) in [0, 1] -> butteraugli XYB
    (OpsinDynamicsImage, butteraugli.cc:1473-1545)."""
    rgb = rgb_linear * intensity_target
    blurred = np.stack([_blur(rgb[c], 1.2) for c in range(3)])
    pre = _opsin_absorbance(blurred[0], blurred[1], blurred[2], clamp=True)
    sens = []
    for p in pre:
        p = np.maximum(p, 1e-4)
        sens.append(np.maximum(_gamma(p) / p, 1e-4))
    cur = _opsin_absorbance(rgb[0], rgb[1], rgb[2], clamp=False)
    m0 = np.maximum(cur[0] * sens[0], 1.7557483643287353)
    m1 = np.maximum(cur[1] * sens[1], 1.7557483643287353)
    m2 = np.maximum(cur[2] * sens[2], 12.226454707163354)
    return np.stack([m0 - m1, m0 + m1, m2])


def _remove_range(x, w):
    return np.where(x > w, x - w, np.where(x < -w, x + w, 0.0))


def _amplify_range(x, w):
    return np.where(x > w, x + w, np.where(x < -w, x - w, 2.0 * x))


def _maximum_clamp(v, maxval):
    mul = 0.724216145665
    return np.where(v >= maxval, (v - maxval) * mul + maxval,
                    np.where(v < -maxval, (v + maxval) * mul - maxval, v))


def separate_frequencies(xyb: np.ndarray):
    """-> (lf(3), mf(3), hf[2], uhf[2]) (SeparateFrequencies,
    butteraugli.cc:395-545)."""
    sigma_lf, sigma_hf, sigma_uhf = 7.15593339443, 3.22489901262,         1.56416327805
    lf = np.stack([_blur(xyb[c], sigma_lf) for c in range(3)])
    mf = xyb - lf
    # XybLowFreqToVals on lf
    lx, ly, lb = lf[0], lf[1], lf[2]
    lf = np.stack([lx * 33.832837186260, ly * 14.458268100570,
                   (lb - 0.362267051518 * ly) * 49.87984651440])
    hf = [None, None]
    for c in range(3):
        if c == 2:
            mf[2] = _blur(mf[2], sigma_hf)
            break
        blurred = _blur(mf[c], sigma_hf)
        hf[c] = mf[c] - blurred
        mf[c] = _remove_range(blurred, 0.29) if c == 0             else _amplify_range(blurred, 0.1)
    # SuppressXByY
    s = 0.653020556257
    scaler = s + (1.0 - s) * (46.0 / (hf[1] * hf[1] + 46.0))
    hf[0] = hf[0] * scaler
    uhf = [None, None]
    for c in range(2):
        blurred = _blur(hf[c], sigma_uhf)
        uhf[c] = hf[c] - blurred
        if c == 0:
            hf[0] = _remove_range(blurred, 1.5)
            uhf[0] = _remove_range(uhf[0], 0.04)
        else:
            h = _maximum_clamp(blurred, 28.4691806922)
            uhf[1] = _maximum_clamp(uhf[1], 5.19175294647) * 2.69313763794
            hf[1] = _amplify_range(h * 2.155, 0.132)
    return lf, mf, hf, uhf


def _malta_diffs(v0, v1, w_0gt1, w_0lt1, norm1, mulli):
    """Asymmetric per-pixel difference feeding the Malta filters
    (MaltaDiffMapT preamble, butteraugli.cc:985-1040)."""
    len_ = 3.75
    w_pre0gt1 = mulli * np.sqrt(0.5 * w_0gt1) / (len_ * 2 + 1)
    w_pre0lt1 = mulli * np.sqrt(0.33 * w_0lt1) / (len_ * 2 + 1)
    norm2_0gt1 = w_pre0gt1 * norm1
    norm2_0lt1 = w_pre0lt1 * norm1
    absval = 0.5 * (np.abs(v0) + np.abs(v1))
    diff = v0 - v1
    scaler = norm2_0gt1 / (norm1 + absval)
    diffs = scaler * diff
    scaler2 = norm2_0lt1 / (norm1 + absval)
    fabs0 = np.abs(v0)
    too_small = 0.55 * fabs0
    too_big = 1.05 * fabs0
    neg = v0 < 0
    impact_neg = np.where(
        v1 > -too_small, scaler2 * (v1 + too_small),
        np.where(v1 < -too_big, -(scaler2 * (-v1 - too_big)), 0.0))
    impact_pos = np.where(
        v1 < too_small, scaler2 * (too_small - v1),
        np.where(v1 > too_big, -(scaler2 * (v1 - too_big)), 0.0))
    return diffs + np.where(neg, -impact_neg, impact_pos)


def _malta_filter(diffs: np.ndarray, patterns) -> np.ndarray:
    """Sum over 16 directions of (line sum)^2, zero padding
    (MaltaUnit + PaddedMaltaUnit)."""
    h, w = diffs.shape
    p = np.pad(diffs, 4)
    out = np.zeros((h, w))
    for taps in patterns:
        acc = np.zeros((h, w))
        for (dy, dx) in taps:
            acc += p[4 + dy:4 + dy + h, 4 + dx:4 + dx + w]
        out += acc * acc
    return out


def _malta_diff_map(v0, v1, w_0gt1, w_0lt1, norm1, lf: bool):
    mulli = 0.611612573796 if lf else 0.39905817637
    diffs = _malta_diffs(v0, v1, w_0gt1, w_0lt1, norm1, mulli)
    return _malta_filter(diffs, MALTA_LF if lf else MALTA_FULL)


def _fuzzy_erosion(src: np.ndarray) -> np.ndarray:
    """Weighted 3-smallest over self + 8 neighbors at distance 3;
    out-of-bounds samples are skipped (butteraugli.cc:1180-1218)."""
    h, w = src.shape
    big = np.inf
    planes = [src]
    for dy in (-3, 0, 3):
        for dx in (-3, 0, 3):
            if dy == 0 and dx == 0:
                continue
            sh = np.full((h, w), big)
            y0, y1 = max(0, -dy), min(h, h - dy)
            x0, x1 = max(0, -dx), min(w, w - dx)
            sh[y0:y1, x0:x1] = src[y0 + dy:y1 + dy, x0 + dx:x1 + dx]
            planes.append(sh)
    stack = np.stack(planes)
    part = np.partition(stack, 2, axis=0)
    m0 = part[0]
    # the reference initializes min1 = min2 = 2*min0, so missing or
    # distant samples are capped at twice the smallest
    m1 = np.minimum(part[1], 2 * m0)
    m2 = np.minimum(part[2], 2 * m0)
    return 0.45 * m0 + 0.3 * m1 + 0.25 * m2


def _mask_psycho(hf0, uhf0, hf1, uhf1, block_diff_ac_y):
    """CombineChannelsForMasking + Mask (butteraugli.cc:1107-1260).
    Returns mask; adds the mask-difference error to block_diff_ac_y."""
    def combine(hf, uhf):
        xdiff = (uhf[0] + hf[0]) * 2.5
        ydiff = uhf[1] * 0.4 + hf[1] * 0.4
        return np.sqrt(xdiff * xdiff + ydiff * ydiff)

    def precompute(m):
        mul, bias = 6.19424080439, 12.61050594197
        b = mul * bias
        return np.sqrt(mul * np.abs(m) + b) - np.sqrt(b)

    mask0 = combine(hf0, uhf0)
    mask1 = combine(hf1, uhf1)
    blurred0 = _blur(precompute(mask0), 2.7)
    blurred1 = _blur(precompute(mask1), 2.7)
    block_diff_ac_y += 10.0 * (blurred0 - blurred1) ** 2
    return _fuzzy_erosion(blurred0)


def _mask_y(delta):
    c = 2.5485944793 / (0.451936922203 * delta + 0.829591754942)
    r = _GLOBAL_SCALE * (1.0 + c)
    return r * r


def _mask_dc_y(delta):
    c = 0.505054525019 / (3.87449418804 * delta + 0.20025578522)
    r = _GLOBAL_SCALE * (1.0 + c)
    return r * r


def _diffmap_full(xyb0, xyb1, hf_asymmetry, xmul):
    """Full-resolution diffmap (DiffmapPsychoImage,
    butteraugli.cc:1899-1958)."""
    lf0, mf0, hf0, uhf0 = separate_frequencies(xyb0)
    lf1, mf1, hf1, uhf1 = separate_frequencies(xyb1)
    h, w = xyb0.shape[1:]
    ac = np.zeros((3, h, w))
    sq = np.sqrt(hf_asymmetry)
    ac[1] += _malta_diff_map(uhf0[1], uhf1[1], W_UHF_MALTA * hf_asymmetry,
                             W_UHF_MALTA / hf_asymmetry, NORM1_UHF, lf=False)
    ac[0] += _malta_diff_map(uhf0[0], uhf1[0], W_UHF_MALTA_X * hf_asymmetry,
                             W_UHF_MALTA_X / hf_asymmetry, NORM1_UHF_X,
                             lf=False)
    ac[1] += _malta_diff_map(hf0[1], hf1[1], W_HF_MALTA * sq,
                             W_HF_MALTA / sq, NORM1_HF, lf=True)
    ac[0] += _malta_diff_map(hf0[0], hf1[0], W_HF_MALTA_X * sq,
                             W_HF_MALTA_X / sq, NORM1_HF_X, lf=True)
    ac[1] += _malta_diff_map(mf0[1], mf1[1], W_MF_MALTA, W_MF_MALTA,
                             NORM1_MF, lf=True)
    ac[0] += _malta_diff_map(mf0[0], mf1[0], W_MF_MALTA_X, W_MF_MALTA_X,
                             NORM1_MF_X, lf=True)
    dc = np.zeros((3, h, w))
    for c in range(3):
        if c < 2:  # L2DiffAsymmetric with 0.8 pre-scale
            d = hf0[c] - hf1[c]
            total = d * d * (WMUL[c] * hf_asymmetry * 0.8)
            fabs0 = np.abs(hf0[c])
            too_small = 0.4 * fabs0
            too_big = fabs0
            v = np.where(
                hf0[c] < 0,
                np.where(hf1[c] > -too_small, hf1[c] + too_small,
                         np.where(hf1[c] < -too_big, -hf1[c] - too_big,
                                  0.0)),
                np.where(hf1[c] < too_small, too_small - hf1[c],
                         np.where(hf1[c] > too_big, hf1[c] - too_big,
                                  0.0)))
            ac[c] += total + (WMUL[c] / hf_asymmetry * 0.8) * v * v
        ac[c] += WMUL[3 + c] * (mf0[c] - mf1[c]) ** 2
        dc[c] = WMUL[6 + c] * (lf0[c] - lf1[c]) ** 2
    mask = _mask_psycho(hf0, uhf0, hf1, uhf1, ac[1])
    my = _mask_y(mask)
    mdc = _mask_dc_y(mask)
    dsum = (dc[0] * xmul + dc[1] + dc[2]) * mdc
    asum = (ac[0] * xmul + ac[1] + ac[2]) * my
    return np.sqrt(np.maximum(dsum + asum, 0.0))


def _subsample2x(rgb: np.ndarray) -> np.ndarray:
    c, h, w = rgb.shape
    hh, ww = (h + 1) // 2, (w + 1) // 2
    idx_y = np.minimum(np.arange(hh * 2), h - 1)
    idx_x = np.minimum(np.arange(ww * 2), w - 1)
    ext = rgb[:, idx_y][:, :, idx_x]
    return 0.25 * (ext[:, 0::2, 0::2] + ext[:, 1::2, 0::2]
                   + ext[:, 0::2, 1::2] + ext[:, 1::2, 1::2])


def butteraugli_diffmap(rgb0_linear: np.ndarray, rgb1_linear: np.ndarray,
                        hf_asymmetry: float = 0.8, xmul: float = 1.0,
                        intensity_target: float = 80.0) -> np.ndarray:
    """Per-pixel diffmap of two linear RGB (3, H, W) images in [0, 1]
    (ButteraugliComparator::Diffmap incl. the half-res pass)."""
    h, w = rgb0_linear.shape[1:]
    xyb0 = opsin_dynamics_image(rgb0_linear, intensity_target)
    xyb1 = opsin_dynamics_image(rgb1_linear, intensity_target)
    diffmap = _diffmap_full(xyb0, xyb1, hf_asymmetry, xmul)
    if min(h, w) >= 16:  # half-res pass (AddSupersampled2x, w=0.5)
        s0 = opsin_dynamics_image(_subsample2x(rgb0_linear),
                                  intensity_target)
        s1 = opsin_dynamics_image(_subsample2x(rgb1_linear),
                                  intensity_target)
        sub = _diffmap_full(s0, s1, hf_asymmetry, xmul)
        up = np.repeat(np.repeat(sub, 2, 0), 2, 1)[:h, :w]
        diffmap = diffmap * (1.0 - 0.3 * 0.5) + 0.5 * up
    return diffmap


def butteraugli_score(rgb0_linear, rgb1_linear, hf_asymmetry: float = 0.8,
                      intensity_target: float = 80.0) -> float:
    """Butteraugli distance: max of the diffmap
    (ButteraugliScoreFromDiffmap). ~1.0 = visually lossless border."""
    if min(rgb0_linear.shape[1:]) < 8:
        return 0.0
    dm = butteraugli_diffmap(rgb0_linear, rgb1_linear, hf_asymmetry,
                             intensity_target=intensity_target)
    return float(dm.max())
