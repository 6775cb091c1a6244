"""Image quality metrics: PSNR, Butteraugli-style perceptual distance,
multi-scale SSIM in XYB.

PSNR mirrors extras/metrics.h ComputePSNR. The perceptual metrics are
TPU-native reformulations in the spirit of butteraugli/butteraugli.h
(XYB opsin domain, multi-scale contrast masking) — NOT bit-identical to
the reference model; they exist for encoder feedback loops and benchmark
reporting. All heavy math is NumPy/JAX-vectorizable.
"""

from __future__ import annotations

import numpy as np

from ..ops.xyb import linear_rgb_to_xyb, srgb_to_linear


def compute_psnr(a: np.ndarray, b: np.ndarray, max_val: float = 255.0) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(max_val ** 2 / mse))


def _to_xyb01(img: np.ndarray) -> np.ndarray:
    """uint8 sRGB (H, W, 3) -> XYB (3, H, W)."""
    lin = srgb_to_linear(img.astype(np.float64) / 255.0)
    return linear_rgb_to_xyb(np.moveaxis(lin, -1, 0))


def _blur(x: np.ndarray, radius: int = 2) -> np.ndarray:
    """Separable box-ish Gaussian approximation."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0])
    k /= k.sum()
    for axis in (-2, -1):
        x = np.apply_along_axis(
            lambda r: np.convolve(np.pad(r, 2, mode="edge"), k, "valid"),
            axis, x)
    return x


def _downsample2(x: np.ndarray) -> np.ndarray:
    h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :h, :w]
    return (x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2]
            + x[..., 1::2, 1::2]) * 0.25


# channel weights tuned so distance ~1.0 matches "visually lossless"
# d1-style encodes (butteraugli's intent, butteraugli.h:166-212)
_CHANNEL_WEIGHTS = np.array([35.0, 7.0, 1.5])
_SCALE_WEIGHTS = (0.5, 0.3, 0.2)


def butteraugli_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Butteraugli perceptual distance between two uint8 sRGB (H, W, 3)
    images — the faithful model (metrics/butteraugli.py); larger =
    worse, ~1.0 = visually lossless border. Falls back to the fast
    approximate comparator below 8px."""
    if min(a.shape[0], a.shape[1]) >= 8:
        from .butteraugli import butteraugli_score

        lin_a = np.moveaxis(srgb_to_linear(a.astype(np.float64) / 255.0),
                            -1, 0)
        lin_b = np.moveaxis(srgb_to_linear(b.astype(np.float64) / 255.0),
                            -1, 0)
        return butteraugli_score(lin_a, lin_b)
    return butteraugli_distance_approx(a, b)


def butteraugli_distance_approx(a: np.ndarray, b: np.ndarray) -> float:
    """Fast approximate comparator (multi-scale masked XYB difference);
    used for tiny images and as the cheap encoder-side signal."""
    xa = _to_xyb01(a)
    xb = _to_xyb01(b)
    total = 0.0
    for scale, sw in enumerate(_SCALE_WEIGHTS):
        diff = np.abs(xa - xb)
        # local activity masking: high-variance areas tolerate more error
        act = _blur(np.abs(xa - _blur(xa)))
        masked = diff / (1.0 + 8.0 * act)
        # p-norm emphasising worst regions (butteraugli uses max + 3-norm)
        per_channel = np.asarray([
            (np.mean(masked[c] ** 4) ** 0.25) for c in range(3)])
        total += sw * float(np.dot(_CHANNEL_WEIGHTS, per_channel))
        if min(xa.shape[-2:]) < 16:
            break
        xa = _downsample2(xa)
        xb = _downsample2(xb)
    return total * 40.0


def butteraugli_diffmap_xyb(xa: np.ndarray, xb: np.ndarray) -> np.ndarray:
    """Per-pixel perceptual difference of two XYB (3, H, W) images.

    Masked, channel-weighted |diff| at full resolution — the encoder's
    feedback signal (ButteraugliDiffmap analog, butteraugli.h:166; used
    by FindBestQuantization, enc_adaptive_quantization.cc:934)."""
    diff = np.abs(xa - xb)
    act = _blur(np.abs(xa - _blur(xa)))
    masked = diff / (1.0 + 8.0 * act)
    weighted = (_CHANNEL_WEIGHTS[:, None, None] * masked).sum(axis=0)
    return _blur(weighted) * 40.0


def msssim_xyb(a: np.ndarray, b: np.ndarray, scales: int = 4) -> float:
    """Multi-scale SSIM over the XYB Y channel (ssimulacra2-style score in
    [0, 100], higher is better)."""
    ya = _to_xyb01(a)[1]
    yb = _to_xyb01(b)[1]
    c1, c2 = 0.0001, 0.0009
    vals = []
    for _ in range(scales):
        mu_a, mu_b = _blur(ya), _blur(yb)
        va = _blur(ya * ya) - mu_a * mu_a
        vb = _blur(yb * yb) - mu_b * mu_b
        cov = _blur(ya * yb) - mu_a * mu_b
        ssim = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
                / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)))
        vals.append(float(np.mean(ssim)))
        if min(ya.shape) < 16:
            break
        ya, yb = _downsample2(ya), _downsample2(yb)
    score = float(np.prod(np.clip(vals, 0, 1)) ** (1.0 / len(vals)))
    return 100.0 * score
