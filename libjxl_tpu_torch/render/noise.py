"""Noise synthesis: xorshift128+ RNG, random planes, Laplacian convolution,
luma-modulated addition.

Mirrors lib/jxl/xorshift128plus-inl.h:31-95, dec_noise.cc (BitsToFloat,
RandomImage, Random3Planes, DecodeNoise) and
render_pipeline/stage_noise.cc (ConvolveNoiseStage, AddNoiseStage).
Fully vectorized NumPy (lane layout matches the reference exactly, so
noise fields are reproducible bit-for-bit given the same seeds).
"""

from __future__ import annotations

import numpy as np

NOISE_PRECISION = 1 << 10  # noise.h:22
NUM_NOISE_POINTS = 8
_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64(z: np.uint64) -> np.uint64:
    z = np.uint64(z)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class Xorshift128Plus:
    """8-lane xorshift128+ (xorshift128plus-inl.h:31-95).

    Matches the current reference source formula-for-formula (4-seed
    SplitMix64 init, per-lane chaining, 23/18/5 shifts). NOTE: the
    system libjxl 0.7 oracle produces a DIFFERENT bit sequence for the
    same stream (its per-pixel noise fields are uncorrelated with ours
    while every statistic — per-channel std, 0.987 R/G correlation —
    matches exactly), so cross-decoder noise comparisons against that
    oracle are statistical, not per-pixel, at high noise strengths.
    """

    N = 8

    def __init__(self, seed1, seed2, seed3, seed4):
        with np.errstate(over="ignore"):
            s0 = np.zeros(self.N, dtype=np.uint64)
            s1 = np.zeros(self.N, dtype=np.uint64)
            golden = np.uint64(0x9E3779B97F4A7C15)
            s0[0] = _splitmix64(
                ((np.uint64(seed1) << np.uint64(32)) + np.uint64(seed2))
                + golden)
            s1[0] = _splitmix64(
                ((np.uint64(seed3) << np.uint64(32)) + np.uint64(seed4))
                + golden)
            for i in range(1, self.N):
                s0[i] = _splitmix64(s0[i - 1])
                s1[i] = _splitmix64(s1[i - 1])
        self.s0 = s0
        self.s1 = s1

    def fill(self) -> np.ndarray:
        """Returns 8 uint64 random values; advances state."""
        with np.errstate(over="ignore"):
            s1 = self.s0.copy()
            s0 = self.s1.copy()
            bits = s1 + s0
            self.s0 = s0
            s1 = s1 ^ (s1 << np.uint64(23))
            s1 = s1 ^ s0 ^ (s1 >> np.uint64(18)) ^ (s0 >> np.uint64(5))
            self.s1 = s1
        return bits


def bits_to_floats(batch_u64: np.ndarray) -> np.ndarray:
    """u64 batch -> 16 floats in [1, 2) (dec_noise.cc:39-48)."""
    u32 = batch_u64.view(np.uint32)  # little-endian split
    rand12 = ((u32 >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return rand12


def random_image(rng: Xorshift128Plus, xsize: int, ysize: int) -> np.ndarray:
    """RandomImage (dec_noise.cc:50-84): exact batch layout."""
    out = np.zeros((ysize, xsize), dtype=np.float32)
    kf = Xorshift128Plus.N * 2  # floats per batch
    for y in range(ysize):
        x = 0
        while x + kf < xsize:
            out[y, x:x + kf] = bits_to_floats(rng.fill())
            x += kf
        batch = bits_to_floats(rng.fill())
        # trailing pixels in vector-size (8) steps from one batch
        pos = 0
        while x < xsize:
            n = min(8, xsize - x)
            out[y, x:x + n] = batch[pos:pos + n]
            x += 8
            pos += 8
    return out


def random_3planes(visible_frame: int, nonvisible_frame: int, x0: int,
                   y0: int, xsize: int, ysize: int):
    rng = Xorshift128Plus(visible_frame, nonvisible_frame, x0, y0)
    return [random_image(rng, xsize, ysize) for _ in range(3)]


def convolve_noise(plane: np.ndarray) -> np.ndarray:
    """ConvolveNoiseStage: out = 0.16*sum(5x5 box minus center) - 3.84*center
    (stage_noise.cc:241-279)."""
    p = np.pad(plane, 2, mode="symmetric")
    h, w = plane.shape
    acc = np.zeros((h, w), dtype=np.float64)
    for dy in range(5):
        for dx in range(5):
            if dy == 2 and dx == 2:
                continue
            acc += p[dy:dy + h, dx:dx + w]
    return (acc * 0.16 - 3.84 * plane).astype(np.float32)


def noise_strength(lut, x: np.ndarray) -> np.ndarray:
    """StrengthEvalLut + clamp to [0, 1] (stage_noise.cc:41-123)."""
    lut = np.asarray(lut, dtype=np.float64)
    scale = NUM_NOISE_POINTS - 2
    sx = np.maximum(0.0, x * scale)
    fx = np.floor(sx)
    frac = sx - fx
    over = sx >= scale + 1
    fx = np.where(over, scale, fx)
    frac = np.where(over, 1.0, frac)
    fi = fx.astype(np.int64)
    val = lut[fi] * (1.0 - frac) + lut[fi + 1] * frac
    return np.clip(val, 0.0, 1.0)


def add_noise(xyb: np.ndarray, noise_planes, lut, ytox: float,
              ytob: float, preconvolved: bool = False) -> np.ndarray:
    """AddNoiseStage (stage_noise.cc:127-225).

    preconvolved: noise_planes already went through convolve_noise (the
    low-memory strip decoder convolves with a cross-strip halo first)."""
    norm_const = 0.22
    rnd_r, rnd_g, rnd_c = noise_planes if preconvolved \
        else [convolve_noise(p) for p in noise_planes]
    vx, vy, vb = xyb[0], xyb[1], xyb[2]
    in_g = (vy - vx) * 0.5
    in_r = (vy + vx) * 0.5
    strength_g = noise_strength(lut, in_g)
    strength_r = noise_strength(lut, in_r)
    kc, kn = 0.9921875, 0.0078125
    red_noise = strength_r * (kn * rnd_r * norm_const
                              + kc * rnd_c * norm_const)
    green_noise = strength_g * (kn * rnd_g * norm_const
                                + kc * rnd_c * norm_const)
    rg = red_noise + green_noise
    out = xyb.copy()
    out[0] = vx + ytox * rg + (red_noise - green_noise)
    out[1] = vy + rg
    out[2] = vb + ytob * rg
    return out


def decode_noise(r) -> list:
    """DecodeNoise (dec_noise.cc:142-152): 8 x 10-bit LUT values."""
    return [r.read_bits(10) / NOISE_PRECISION for _ in range(NUM_NOISE_POINTS)]


def encode_noise(lut, w) -> None:
    for v in lut:
        q = int(round(v * NOISE_PRECISION))
        if not 0 <= q < (1 << 10):
            raise ValueError("noise LUT value out of range")
        w.write(10, q)


def photon_noise_lut(iso: float = 800.0, xsize: int = 3456,
                     ysize: int = 2304) -> list:
    """SimulatePhotonNoise (enc_photon_noise.cc:43-92): the physical
    sensor model — photon shot noise + read noise + PRNU for a 35mm
    sensor at the given ISO, converted through the opsin derivative
    into the 8-point intensity->strength LUT. Defaults to an 8 MP
    sensor when the caller does not pass dimensions."""
    k_photons_per_lxs_per_um2 = 11260.0
    k_qe = 0.20
    k_prnu = 0.005
    k_read_noise = 3.0
    k_sensor_area_um2 = 36000.0 * 24000.0
    k_opsin_bias = 0.0037930732552754493
    bias_cbrt = k_opsin_bias ** (1.0 / 3.0)

    h_18 = 10.0 / iso
    pixel_area_um2 = k_sensor_area_um2 / (xsize * ysize)
    electrons_per_pixel_18 = (k_qe * k_photons_per_lxs_per_um2 * h_18
                              * pixel_area_um2)
    lut = []
    for i in range(NUM_NOISE_POINTS):
        scaled_index = i / (NUM_NOISE_POINTS - 2.0)
        y = 2.0 * scaled_index
        linear = max(0.0, (y - bias_cbrt) ** 3 + k_opsin_bias)
        electrons_per_pixel = electrons_per_pixel_18 * (linear / 0.18)
        if electrons_per_pixel <= 0:
            lut.append(0.0)
            continue
        noise = np.sqrt(k_read_noise ** 2 + electrons_per_pixel
                        + (k_prnu * electrons_per_pixel) ** 2)
        linear_noise = noise * (0.18 / electrons_per_pixel_18)
        opsin_derivative = (1.0 / 3.0) / (
            (linear - k_opsin_bias) ** (1.0 / 3.0)) ** 2
        opsin_noise = linear_noise * opsin_derivative
        lut.append(float(np.clip(
            opsin_noise / (0.22 * np.sqrt(2.0) * 1.13), 0.0, 1.0)))
    return lut


# -------------------------------------------------------------- estimation
def _index_and_frac(x):
    """IndexAndFrac (noise.h:42-55), vectorized."""
    scale = 8 - 2  # kNumNoisePoints - 2
    scaled = np.maximum(0.0, np.asarray(x, dtype=np.float64) * scale)
    floor = np.floor(scaled)
    frac = scaled - floor
    over = scaled >= scale + 1
    floor = np.where(over, scale, floor)
    frac = np.where(over, 1.0, frac)
    return floor.astype(np.int64), frac


def estimate_noise(xyb: np.ndarray, quality_coef: float = 1.0):
    """Content-based noise estimation (GetNoiseParameter,
    enc_noise.cc:328): texture-mask 8x8 patches via center-window SADs,
    measure Laplacian energy on the flat ones, and fit the 8-point
    intensity->noise LUT with the reference's asymmetric regularized
    loss. Returns the LUT (list of 8 floats) or None (no noise / image
    too patterned)."""
    v = 0.5 * (xyb[0] + xyb[1])
    h, w = v.shape
    hp, wp = h // 8, w // 8
    if hp == 0 or wp == 0:
        return None
    p = v[:hp * 8, :wp * 8].reshape(hp, 8, wp, 8).transpose(0, 2, 1, 3)
    # SAD texture score: 4x3 windows vs the center window at offset 2
    center = p[:, :, 2:6, 2:5]
    sads = np.empty((20, hp, wp))
    i = 0
    for ybl in range(4):
        for xbl in range(5):
            win = p[:, :, ybl:ybl + 4, xbl:xbl + 3]
            sads[i] = np.abs(win - center).sum(axis=(2, 3))
            i += 1
    sads.sort(axis=0)
    scores = sads[:10].mean(axis=0)  # robust lower half (ROAD-style)
    bins = np.clip((scores * 256).astype(np.int64), 0, 255)
    hist = np.bincount(bins.reshape(-1), minlength=256)
    threshold = int(hist.argmax()) / 256.0
    if threshold > 0.15 or threshold <= 0.0:
        return None
    flat = scores <= threshold
    if not flat.any():
        return None
    # Laplacian noise level on flat patches (in-block reflect borders)
    lapl = np.array([[-0.25, -1.0, -0.25],
                     [-1.0, 5.0, -1.0],
                     [-0.25, -1.0, -0.25]])
    pp = np.pad(p, ((0, 0), (0, 0), (1, 1), (1, 1)), mode="reflect")
    filt = np.zeros_like(p)
    for dy in range(3):
        for dx in range(3):
            filt += lapl[dy, dx] * pp[:, :, dy:dy + 8, dx:dx + 8]
    noise_lvl = np.abs(filt).mean(axis=(2, 3))[flat]
    intensity = p.mean(axis=(2, 3))[flat]
    # fit the LUT (OptimizeNoiseParameters: asymmetric + smoothness reg)
    k_reg, k_asym = 0.005, 1.1
    n = len(intensity)
    idx, frac = _index_and_frac(intensity)
    idx = np.minimum(idx, 6)
    wvec = np.full(8, noise_lvl.mean())
    lr = 0.5
    for _ in range(200):
        val = wvec[idx] * (1 - frac) + wvec[idx + 1] * frac
        dist = val - noise_lvl
        asym = np.where(dist > 0, k_asym, 1.0)
        grad = np.zeros(8)
        np.add.at(grad, idx, asym * (1 - frac) * dist)
        np.add.at(grad, idx + 1, asym * frac * dist)
        diff = wvec[:-1] - wvec[1:]
        grad[:-1] += k_reg * n * diff
        grad[1:] -= k_reg * n * diff
        wvec -= lr * grad / n
    val = wvec[idx] * (1 - frac) + wvec[idx + 1] * frac
    dist = val - noise_lvl
    loss = float((np.where(dist > 0, k_asym, 1.0) * dist * dist).mean())
    if loss > 1e-3:
        return None
    lut = [max(0.0, float(x)) * quality_coef * 1.4 for x in wvec]
    if not any(x > 0 for x in lut):
        return None
    return lut
