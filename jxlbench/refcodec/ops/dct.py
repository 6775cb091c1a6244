"""DCT kernels for the VarDCT transform zoo.

The JPEG XL DCT convention (lib/jxl/dct-inl.h + dct_scales.h):
  1D forward:  F(u) = (c(u)/N) * sum_k x(k) cos((2k+1) u pi / (2N)),
  1D inverse:  x(k) = sum_u  c(u) F(u) cos((2k+1) u pi / (2N)),
with c(0)=1, c(u>0)=sqrt(2): DC equals the block mean, and fwd/inv are exact
inverses. 2D transforms are separable; coefficient blocks of R x C
transforms are stored in "wide" layout (rows = min(R,C), cols = max(R,C)),
matching CoefficientLayout (ac_strategy.cc:20-27).

Implemented as dense matrix products: on TPU these map directly onto the
MXU (a 256-point DCT is a 256x256 matmul), which beats any split-radix
schedule the reference hand-writes for CPU SIMD — the idiomatic TPU design
per SURVEY.md section 7 item 4.
"""

from __future__ import annotations

import functools

import numpy as np

SIZES = (1, 2, 4, 8, 16, 32, 64, 128, 256)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """C_N[u,k] = c(u) cos((2k+1) u pi / (2N)) (float64)."""
    k = np.arange(n)
    u = np.arange(n)[:, None]
    mat = np.cos((2 * k[None, :] + 1) * u * np.pi / (2 * n))
    mat[1:, :] *= np.sqrt(2.0)
    return mat


@functools.lru_cache(maxsize=None)
def fwd_matrix(n: int) -> np.ndarray:
    return dct_matrix(n) / n


@functools.lru_cache(maxsize=None)
def inv_matrix(n: int) -> np.ndarray:
    return dct_matrix(n).T.copy()


@functools.lru_cache(maxsize=None)
def _fwd32(n: int) -> np.ndarray:
    return fwd_matrix(n).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _inv32(n: int) -> np.ndarray:
    return inv_matrix(n).astype(np.float32)


def dct2d(pixels: np.ndarray) -> np.ndarray:
    """Forward 2D DCT of an (..., R, C) block -> wide-layout coefficients
    (..., min, max). dtype-following: float32 input uses float32
    matrices (sgemm), anything else float64."""
    r, c = pixels.shape[-2:]
    f = _fwd32 if pixels.dtype == np.float32 else fwd_matrix
    # two broadcasting matmuls: BLAS-backed and free of einsum's
    # per-call contraction-path search
    out = f(r) @ pixels @ f(c).T
    if r < c:
        return out
    # tall AND square blocks are stored transposed ([hfreq][vfreq]) —
    # ComputeScaledDCT's ROWS >= COLS branch skips the final transpose
    # (dct-inl.h ComputeScaledDCT; verified against libjxl decodes)
    return np.swapaxes(out, -2, -1)


def idct2d(coeffs: np.ndarray, r: int, c: int) -> np.ndarray:
    """Inverse of dct2d: wide-layout (..., min, max) -> (..., R, C) pixels.
    dtype-following like dct2d."""
    if r >= c:
        coeffs = np.swapaxes(coeffs, -2, -1)
    m = _inv32 if coeffs.dtype == np.float32 else inv_matrix
    return m(r) @ coeffs @ m(c).T


@functools.lru_cache(maxsize=None)
def resample_scales(n: int, to: int) -> np.ndarray:
    """DCTResampleScales<8*to/..., ...> generalization (dct_scales.h:18-42):
    scale factor for coefficient i when reinterpreting an n-point DCT's
    low frequencies as those of a `to`-point DCT over the same support
    (n < to: upsampling scales; see dct_scales.h python snippet)."""
    if n == to:
        return np.ones(n)
    # scales for FROM=to, TO=n (downsampling the basis): product of
    # cos(i / (2*N) * pi) terms for each halving step.
    small, big = (n, to) if n < to else (to, n)
    scales = np.ones(small)
    i = np.arange(small)
    nn = big
    while nn != small:
        scales *= np.cos(i / (2 * nn) * np.pi)
        nn //= 2
    return scales

