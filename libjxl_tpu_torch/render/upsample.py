"""Signaled 2x/4x/8x upsampling (render_pipeline/stage_upsampling.cc).

Kernels are generated by symmetry from the unique coefficients stored in
CustomTransformData (defaults in io/upsample_defaults.py); each output
subpixel phase correlates a mirrored 5x5 kernel against the low-res image.
"""

from __future__ import annotations

import functools

import numpy as np

from ..io import upsample_defaults as upd


def _kernel_bank(weights, shift: int) -> np.ndarray:
    """kernel[j//5][i//5][j%5][i%5] (stage_upsampling.cc:36-46);
    returns (N/2, N/2, 5, 5) with N = 1 << shift... bank index [ky][kx]."""
    n = 1 << (shift - 1)
    bank = np.zeros((n, n, 5, 5))
    for i in range(5 * n):
        for j in range(5 * n):
            y = min(i, j)
            x = max(i, j)
            bank[j // 5][i // 5][j % 5][i % 5] = \
                weights[5 * n * y - y * (y - 1) // 2 + x - y]
    return bank


def _phase_kernel(bank: np.ndarray, N: int, px: int, py: int) -> np.ndarray:
    """Effective 5x5 kernel for output subpixel (px, py)
    (stage_upsampling.cc Kernel<N>, :88-106)."""
    k = np.zeros((5, 5))
    for iy in range(-2, 3):
        for ix in range(-2, 3):
            jx, jy = ix + 2, iy + 2
            if N == 2:
                v = bank[0][0][4 - jy if py % 2 else jy][4 - jx if px % 2 else jx]
            elif N == 4:
                a = py % 2 if py % 4 < 2 else 1 - py % 2
                b = px % 2 if px % 4 < 2 else 1 - px % 2
                v = bank[a][b][jy if py % 4 < 2 else 4 - jy][
                    jx if px % 4 < 2 else 4 - jx]
            else:  # N == 8
                a = py % 4 if py % 8 < 4 else 3 - py % 4
                b = px % 4 if px % 8 < 4 else 3 - px % 4
                v = bank[a][b][jy if py % 8 < 4 else 4 - jy][
                    jx if px % 8 < 4 else 4 - jx]
            k[jy, jx] = v
    return k


@functools.lru_cache(maxsize=None)
def _default_kernels(N: int):
    weights = {2: upd.UPSAMPLE2_WEIGHTS, 4: upd.UPSAMPLE4_WEIGHTS,
               8: upd.UPSAMPLE8_WEIGHTS}[N]
    return _kernels_for(N, tuple(weights))


@functools.lru_cache(maxsize=16)
def _kernels_for(N: int, weights: tuple):
    shift = (N - 1).bit_length()
    bank = _kernel_bank(weights, shift)
    return [[_phase_kernel(bank, N, px, py) for px in range(N)]
            for py in range(N)]


def kernels_from_metadata(meta, N: int):
    """Per-phase kernels honoring signaled CustomTransformData weights
    (image_metadata.h:179); None -> library defaults."""
    td = getattr(meta, "transform_data", None)
    if td is None or getattr(td, "all_default", True):
        return None
    mask = getattr(td, "custom_weights_mask", 0)
    bit, attr = {2: (1, "upsampling2_weights"),
                 4: (2, "upsampling4_weights"),
                 8: (4, "upsampling8_weights")}[N]
    if not (mask & bit):
        return None
    return _kernels_for(N, tuple(float(x) for x in getattr(td, attr)))


def upsample(plane: np.ndarray, N: int, kernels=None) -> np.ndarray:
    """Upsample (H, W) -> (H*N, W*N) with the signaled 5x5 kernels."""
    if N == 1:
        return plane
    if kernels is None:
        kernels = _default_kernels(N)
    h, w = plane.shape
    p = np.pad(plane, 2, mode="symmetric")
    # per-input-pixel 5x5 support min/max: the reference clamps every
    # upsampled sample to them (stage_upsampling.cc:139-150)
    mn = p[:h, :w].copy()
    mx = p[:h, :w].copy()
    for jy in range(5):
        for jx in range(5):
            if jy == 0 and jx == 0:
                continue
            np.minimum(mn, p[jy:jy + h, jx:jx + w], out=mn)
            np.maximum(mx, p[jy:jy + h, jx:jx + w], out=mx)
    out = np.zeros((h * N, w * N), dtype=np.float64)
    for py in range(N):
        for px in range(N):
            k = kernels[py][px]
            acc = np.zeros((h, w))
            for jy in range(5):
                for jx in range(5):
                    if k[jy, jx] == 0.0:
                        continue
                    acc += k[jy, jx] * p[jy:jy + h, jx:jx + w]
            out[py::N, px::N] = np.clip(acc, mn, mx)
    return out


def downsample_box(plane: np.ndarray, N: int) -> np.ndarray:
    """Encoder-side NxN box downsampling (simple variant of
    DownsampleImage2_Sharper, enc_heuristics.cc:274)."""
    if N == 1:
        return plane
    h, w = plane.shape
    ph = (-h) % N
    pw = (-w) % N
    p = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    hh, ww = p.shape
    return p.reshape(hh // N, N, ww // N, N).mean(axis=(1, 3))


# DownsampleImage2_Sharper 12x12 kernel (enc_heuristics.cc:278-332)
_SHARPER_KERNEL = np.array([
    [-0.000314256996835, -0.000314256996835, -0.000897597057705, -0.000562751488849, -0.000176807273646, 0.001864627368902, 0.001864627368902, -0.000176807273646, -0.000562751488849, -0.000897597057705, -0.000314256996835, -0.000314256996835],
    [-0.000314256996835, -0.001527942804748, -0.000121760530512, 0.000191123989093, 0.010193185932466, 0.058637519197110, 0.058637519197110, 0.010193185932466, 0.000191123989093, -0.000121760530512, -0.001527942804748, -0.000314256996835],
    [-0.000897597057705, -0.000121760530512, 0.000946363683751, 0.007113577630288, 0.000437956841058, -0.000372823835211, -0.000372823835211, 0.000437956841058, 0.007113577630288, 0.000946363683751, -0.000121760530512, -0.000897597057705],
    [-0.000562751488849, 0.000191123989093, 0.007113577630288, 0.044592622228814, 0.000222278879007, -0.162864473015945, -0.162864473015945, 0.000222278879007, 0.044592622228814, 0.007113577630288, 0.000191123989093, -0.000562751488849],
    [-0.000176807273646, 0.010193185932466, 0.000437956841058, 0.000222278879007, -0.000913092543974, -0.017071696107902, -0.017071696107902, -0.000913092543974, 0.000222278879007, 0.000437956841058, 0.010193185932466, -0.000176807273646],
    [0.001864627368902, 0.058637519197110, -0.000372823835211, -0.162864473015945, -0.017071696107902, 0.414660099370354, 0.414660099370354, -0.017071696107902, -0.162864473015945, -0.000372823835211, 0.058637519197110, 0.001864627368902],
    [0.001864627368902, 0.058637519197110, -0.000372823835211, -0.162864473015945, -0.017071696107902, 0.414660099370354, 0.414660099370354, -0.017071696107902, -0.162864473015945, -0.000372823835211, 0.058637519197110, 0.001864627368902],
    [-0.000176807273646, 0.010193185932466, 0.000437956841058, 0.000222278879007, -0.000913092543974, -0.017071696107902, -0.017071696107902, -0.000913092543974, 0.000222278879007, 0.000437956841058, 0.010193185932466, -0.000176807273646],
    [-0.000562751488849, 0.000191123989093, 0.007113577630288, 0.044592622228814, 0.000222278879007, -0.162864473015945, -0.162864473015945, 0.000222278879007, 0.044592622228814, 0.007113577630288, 0.000191123989093, -0.000562751488849],
    [-0.000897597057705, -0.000121760530512, 0.000946363683751, 0.007113577630288, 0.000437956841058, -0.000372823835211, -0.000372823835211, 0.000437956841058, 0.007113577630288, 0.000946363683751, -0.000121760530512, -0.000897597057705],
    [-0.000314256996835, -0.001527942804748, -0.000121760530512, 0.000191123989093, 0.010193185932466, 0.058637519197110, 0.058637519197110, 0.010193185932466, 0.000191123989093, -0.000121760530512, -0.001527942804748, -0.000314256996835],
    [-0.000314256996835, -0.000314256996835, -0.000897597057705, -0.000562751488849, -0.000176807273646, 0.001864627368902, 0.001864627368902, -0.000176807273646, -0.000562751488849, -0.000897597057705, -0.000314256996835, -0.000314256996835],
])


def _second_min_neighbor_diff(image: np.ndarray) -> np.ndarray:
    """CreateMask (enc_heuristics.cc:240-265): second-smallest absolute
    difference to the 4 edge-clamped neighbors."""
    p = np.pad(image, 1, mode="edge")
    h, w = image.shape
    diffs = np.stack([
        np.abs(image - p[1:1 + h, 0:w]),      # west
        np.abs(image - p[1:1 + h, 2:2 + w]),  # east
        np.abs(image - p[0:h, 1:1 + w]),      # north
        np.abs(image - p[2:2 + h, 1:1 + w]),  # south
    ])
    part = np.partition(diffs, 1, axis=0)
    return part[1]


def downsample2_sharper(plane: np.ndarray) -> np.ndarray:
    """Sharper 2x downsampling with ringing suppression
    (DownsampleImage2_Sharper, enc_heuristics.cc:268-380): 12x12
    anti-aliasing kernel at stride 2, result clamped to the local 2x2
    min/max widened by an edge-activity mask of the box-downsampled
    image."""
    h, w = plane.shape
    oh, ow = -(-h // 2), -(-w // 2)
    # clamped index grids: iy = 2y + ky - 5, ix = 2x + kx - 5
    ys = np.clip(2 * np.arange(oh)[:, None] + np.arange(12)[None, :] - 5,
                 0, h - 1)
    xs = np.clip(2 * np.arange(ow)[:, None] + np.arange(12)[None, :] - 5,
                 0, w - 1)
    # windows[y, x, ky, kx] via two gathers
    rows = plane[ys]                     # (oh, 12, w)
    win = rows[:, :, xs]                 # (oh, 12, ow, 12)
    out = np.einsum("ykxj,kj->yx", win, _SHARPER_KERNEL)
    # min/max over the central 2x2 source block (R=5)
    blk = win[:, 5:7][:, :, :, 5:7]
    mn = blk.min(axis=(1, 3))
    mx = blk.max(axis=(1, 3))
    mask = _second_min_neighbor_diff(downsample_box(plane, 2))
    return np.clip(out, mn - mask, mx + mask)


def _anti_upsample2(img: np.ndarray) -> np.ndarray:
    """Transpose of the default 2x upsampler ignoring clamps
    (AntiUpsample, enc_heuristics.cc:546-575): distributes full-res
    values back through the upsampling weights; zero beyond borders."""
    h, w = img.shape
    oh, ow = -(-h // 2), -(-w // 2)
    kernels = _default_kernels(2)
    out = np.zeros((oh, ow))
    for py in range(2):
        for px in range(2):
            sub = np.zeros((oh, ow))
            sub_src = img[py::2, px::2]
            sh, sw = sub_src.shape
            sub[:sh, :sw] = sub_src
            k = kernels[py][px]
            # deriv(x2,y2 -> x,y) = k[y2 - y//2 + 2, x2 - x//2 + 2]:
            # correlation of the phase plane with the flipped kernel
            pad = np.pad(sub, 2, mode="constant")
            for jy in range(5):
                for jx in range(5):
                    wgt = k[4 - jy, 4 - jx]
                    if wgt == 0.0:
                        continue
                    out += wgt * pad[jy:jy + oh, jx:jx + ow]
    return out


def downsample2_iterative(plane: np.ndarray) -> np.ndarray:
    """Iterative 2x downsampling (DownsampleImage2_Iterative,
    enc_heuristics.cc:653-733): start from the sharper result, then 3
    rounds of distributing the upsampling error back through the
    upsampler's transpose; finally clamp to the 3x3 neighborhood of the
    initial result widened by 2x the edge-activity mask."""
    h, w = plane.shape
    mask = _second_min_neighbor_diff(downsample_box(plane, 2))
    initial = downsample2_sharper(plane)
    down = initial.copy()
    weights2 = _anti_upsample2(np.ones((h, w)))
    for _ in range(3):
        up = upsample(down, 2)[:h, :w]
        corr2 = _anti_upsample2(plane - up) / weights2
        down = down + corr2
    # ReduceRinging (enc_heuristics.cc:596-641)
    p = np.pad(initial, 1, mode="edge")
    mn = initial.copy()
    mx = initial.copy()
    oh, ow = initial.shape
    for jy in range(3):
        for jx in range(3):
            np.minimum(mn, p[jy:jy + oh, jx:jx + ow], out=mn)
            np.maximum(mx, p[jy:jy + oh, jx:jx + ow], out=mx)
    a = mask * 2.0
    return np.clip(down, mn - a, mx + a)
