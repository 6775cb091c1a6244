"""SSIMULACRA 2 perceptual metric (Jon Sneyers, Cloudinary, v2.1).

Reimplements tools/ssimulacra2.{h,cc}: XYB color (rescaled, B-Y),
gamma-corrected SSIM map, ringing map (distorted edges where the
original is smooth), blurring map (original edges lost), each at 6
scales (1:1..1:32, downsampled in linear RGB) for 3 components with
1-norm and 4-norm aggregation -> weighted sum of 108 norms -> score
<=100 (tools/ssimulacra2.cc:296-445).

The Gaussian blur reproduces the reference's recursive IIR filter
(tools/gauss_blur.cc CreateRecursiveGaussian, sigma=1.5) exactly:
out_k[n] = n2_k*(in[n-N-1]+in[n+N-1]) - d1_k*out_k[n-1] - out_k[n-2]
summed over three cosine components k, zero initial state.

Score guide (from the reference header): 30 = low, 50 = medium,
70 = high, 90 = visually lossless.
"""

from __future__ import annotations

import numpy as np

from ..ops.xyb import linear_rgb_to_xyb, srgb_to_linear

_KC2 = 0.0009
_NUM_SCALES = 6

# tools/ssimulacra2.cc:300-395 — fitted on CID22/TID2013/Kadid10k/KonFiG
_WEIGHTS = np.array([
    0.0, 0.0007376606707406586, 0.0,
    0.0, 0.0007793481682867309, 0.0,
    0.0, 0.0004371155730107379, 0.0,
    1.1041726426657346, 0.00066284834129271, 0.00015231632783718752,
    0.0, 0.0016406437456599754, 0.0,
    1.8422455520539298, 11.441172603757666, 0.0,
    0.0007989109436015163, 0.000176816438078653, 0.0,
    1.8787594979546387, 10.94906990605142, 0.0,
    0.0007289346991508072, 0.9677937080626833, 0.0,
    0.00014003424285435884, 0.9981766977854967, 0.00031949755934435053,
    0.0004550992113792063, 0.0, 0.0,
    0.0013648766163243398, 0.0, 0.0,
    0.0, 0.0, 0.0,
    7.466890328078848, 0.0, 17.445833984131262,
    0.0006235601634041466, 0.0, 0.0,
    6.683678146179332, 0.00037724407979611296, 1.027889937768264,
    225.20515300849274, 0.0, 0.0,
    19.213238186143016, 0.0011401524586618361, 0.001237755635509985,
    176.39317598450694, 0.0, 0.0,
    24.43300999870476, 0.28520802612117757, 0.0004485436923833408,
    0.0, 0.0, 0.0,
    34.77906344483772, 44.835625328877896, 0.0,
    0.0, 0.0, 0.0,
    0.0, 0.0, 0.0,
    0.0, 0.0008680556573291698, 0.0,
    0.0, 0.0, 0.0,
    0.0, 0.0005313191874358747, 0.0,
    0.00016533814161379112, 0.0, 0.0,
    0.0, 0.0, 0.0,
    0.0004179171803251336, 0.0017290828234722833, 0.0,
    0.0020827005846636437, 0.0, 0.0,
    8.826982764996862, 23.19243343998926, 0.0,
    95.1080498811086, 0.9863978034400682, 0.9834382792465353,
    0.0012286405048278493, 171.2667255897307, 0.9807858872435379,
    0.0, 0.0, 0.0,
    0.0005130064588990679, 0.0, 0.00010854057858411537,
], dtype=np.float64)


def _recursive_gaussian_params(sigma: float):
    """Charalampidis (2016) 3-component cosine-sum IIR constants
    (tools/gauss_blur.cc:343-400)."""
    radius = round(3.2795 * sigma + 0.2546)
    omega = np.array([1.0, 3.0, 5.0]) * (np.pi / (2.0 * radius))
    p = np.array([1.0 / np.tan(0.5 * omega[0]),
                  -1.0 / np.tan(0.5 * omega[1]),
                  1.0 / np.tan(0.5 * omega[2])])
    r = np.array([p[0] * p[0] / np.sin(omega[0]),
                  -p[1] * p[1] / np.sin(omega[1]),
                  p[2] * p[2] / np.sin(omega[2])])
    rho = np.exp(-0.5 * sigma * sigma * omega * omega) / radius
    d13 = p[0] * r[1] - r[0] * p[1]
    d35 = p[1] * r[2] - r[1] * p[2]
    d51 = p[2] * r[0] - r[2] * p[0]
    zeta15 = d35 / d13
    zeta35 = d51 / d13
    a = np.array([[p[0], p[1], p[2]], [r[0], r[1], r[2]],
                  [zeta15, zeta35, 1.0]])
    gamma = np.array([1.0, radius * radius - sigma * sigma,
                      zeta15 * rho[0] + zeta35 * rho[1] + rho[2]])
    beta = np.linalg.solve(a, gamma)
    n2 = -beta * np.cos(omega * (radius + 1.0))
    d1 = -2.0 * np.cos(omega)
    return int(radius), n2.astype(np.float32), d1.astype(np.float32)


_RG_CACHE: dict = {}


def _blur_axis0(img: np.ndarray, sigma: float = 1.5) -> np.ndarray:
    """Recursive Gaussian along axis 0, vectorized across axis 1.
    Zero boundary state, matching FastGaussian (gauss_blur.cc:40-160)."""
    key = round(sigma * 1000)
    if key not in _RG_CACHE:
        _RG_CACHE[key] = _recursive_gaussian_params(sigma)
    big_n, n2, d1 = _RG_CACHE[key]
    h, w = img.shape
    out = np.empty_like(img)
    prev = np.zeros((3, w), np.float32)
    prev2 = np.zeros((3, w), np.float32)
    zero = np.zeros((w,), np.float32)
    for n in range(-big_n + 1, h):
        left = n - big_n - 1
        right = n + big_n - 1
        s = (img[left] if left >= 0 else zero) + (
            img[right] if right < h else zero)
        cur = n2[:, None] * s[None, :] - d1[:, None] * prev - prev2
        prev2 = prev
        prev = cur
        if n >= 0:
            out[n] = cur.sum(axis=0)
    return out


def _blur(plane: np.ndarray, sigma: float = 1.5) -> np.ndarray:
    return _blur_axis0(np.ascontiguousarray(
        _blur_axis0(plane, sigma).T), sigma).T


def _downsample2(rgb: np.ndarray) -> np.ndarray:
    """2x2 box downsample with edge clamping (Downsample,
    ssimulacra2.cc:57-81); rgb: (3, H, W) linear."""
    c, h, w = rgb.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    idx_y = np.minimum(np.arange(oh * 2), h - 1)
    idx_x = np.minimum(np.arange(ow * 2), w - 1)
    ext = rgb[:, idx_y][:, :, idx_x]
    return 0.25 * (ext[:, 0::2, 0::2] + ext[:, 1::2, 0::2] +
                   ext[:, 0::2, 1::2] + ext[:, 1::2, 1::2])


def _positive_xyb(linear: np.ndarray) -> np.ndarray:
    """Linear RGB (3,H,W) -> rescaled XYB with B-Y
    (MakePositiveXYB, ssimulacra2.cc:235-247)."""
    xyb = linear_rgb_to_xyb(linear).astype(np.float32)
    x, y, b = xyb[0], xyb[1], xyb[2]
    return np.stack([x * 14.0 + 0.42, y + 0.01, (b - y) + 0.55])


def _ssim_map_norms(mu1, mu2, s11, s22, s12):
    """Per-channel (1-norm, 4-norm) of 1-SSIM' (SSIMMap,
    ssimulacra2.cc:140-186)."""
    out = np.empty(6)
    for c in range(3):
        m1, m2 = mu1[c], mu2[c]
        num_m = 1.0 - (m1 - m2) * (m1 - m2)
        num_s = 2.0 * (s12[c] - m1 * m2) + _KC2
        denom_s = (s11[c] - m1 * m1) + (s22[c] - m2 * m2) + _KC2
        d = np.maximum(1.0 - (num_m * num_s / denom_s), 0.0).astype(
            np.float64)
        out[c * 2] = d.mean()
        out[c * 2 + 1] = np.sqrt(np.sqrt((d ** 4).mean()))
    return out


def _edge_diff_norms(img1, mu1, img2, mu2):
    """Per-channel (ringing 1/4-norm, blur 1/4-norm) (EdgeDiffMap,
    ssimulacra2.cc:188-220)."""
    out = np.empty(12)
    for c in range(3):
        d1 = ((1.0 + np.abs(img2[c] - mu2[c])) /
              (1.0 + np.abs(img1[c] - mu1[c]))) - 1.0
        d1 = d1.astype(np.float64)
        artifact = np.maximum(d1, 0.0)
        detail_lost = np.maximum(-d1, 0.0)
        out[c * 4] = artifact.mean()
        out[c * 4 + 1] = np.sqrt(np.sqrt((artifact ** 4).mean()))
        out[c * 4 + 2] = detail_lost.mean()
        out[c * 4 + 3] = np.sqrt(np.sqrt((detail_lost ** 4).mean()))
    return out


def _to_linear(img: np.ndarray, bg: float) -> np.ndarray:
    """Input (H,W,3|4) uint8 sRGB or float [0,1] -> (3,H,W) linear,
    alpha blended over bg (AlphaBlend, ssimulacra2.cc:249-262)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    if img.dtype == np.uint8:
        img = img.astype(np.float64) / 255.0
    elif img.dtype == np.uint16:
        img = img.astype(np.float64) / 65535.0
    else:
        img = img.astype(np.float64)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    if img.shape[2] >= 4:
        a = img[:, :, 3:4]
        img = a * img[:, :, :3] + (1.0 - a) * bg
    else:
        img = img[:, :, :3]
    return np.moveaxis(srgb_to_linear(img), -1, 0).astype(np.float32)


def ssimulacra2(orig: np.ndarray, dist: np.ndarray,
                bg: float = 0.5) -> float:
    """SSIMULACRA 2.1 score: 100 = identical, <0 possible for very
    distorted pairs. Inputs: (H,W,3|4) uint8/uint16 sRGB or float
    [0,1] sRGB; both at least 8x8 and equal size
    (ComputeSSIMULACRA2, ssimulacra2.cc:447-519)."""
    o = _to_linear(orig, bg)
    d = _to_linear(dist, bg)
    if o.shape != d.shape:
        raise ValueError(f"image sizes differ: {o.shape} vs {d.shape}")
    if o.shape[1] < 8 or o.shape[2] < 8:
        raise ValueError("images must be at least 8x8")
    norms = []  # per scale: (ssim[6], edgediff[12])
    for scale in range(_NUM_SCALES):
        if o.shape[1] < 8 or o.shape[2] < 8:
            break
        if scale:
            o = _downsample2(o)
            d = _downsample2(d)
        img1 = _positive_xyb(o)
        img2 = _positive_xyb(d)
        mu1 = np.stack([_blur(img1[c]) for c in range(3)])
        mu2 = np.stack([_blur(img2[c]) for c in range(3)])
        s11 = np.stack([_blur(img1[c] * img1[c]) for c in range(3)])
        s22 = np.stack([_blur(img2[c] * img2[c]) for c in range(3)])
        s12 = np.stack([_blur(img1[c] * img2[c]) for c in range(3)])
        norms.append((_ssim_map_norms(mu1, mu2, s11, s22, s12),
                      _edge_diff_norms(img1, mu1, img2, mu2)))
    ssim = 0.0
    i = 0
    for c in range(3):
        for scale in range(len(norms)):
            avg_ssim, avg_edge = norms[scale]
            for n in range(2):
                ssim += _WEIGHTS[i] * abs(avg_ssim[c * 2 + n])
                i += 1
                ssim += _WEIGHTS[i] * abs(avg_edge[c * 4 + n])
                i += 1
                ssim += _WEIGHTS[i] * abs(avg_edge[c * 4 + n + 2])
                i += 1
    ssim *= 0.9562382616834844
    ssim = (2.326765642916932 * ssim
            - 0.020884521182843837 * ssim * ssim
            + 6.248496625763138e-05 * ssim * ssim * ssim)
    if ssim > 0:
        return float(100.0 - 10.0 * ssim ** 0.6276336467831387)
    return 100.0
