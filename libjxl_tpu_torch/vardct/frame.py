"""VarDCT frame codec: DC/AC section encode & decode.

Mirrors the reference frame anatomy:
- DC global: quantizer + block ctx map + CfL DC + modular global info
  (dec_frame.cc:61-77, 267-315)
- DC groups: VarDCTDC + ModularDC + ACMetadata modular streams
  (dec_modular.cc:404-532)
- AC global: dequant matrices, num histogram sets, coeff orders, histograms
  (dec_frame.cc:367-430)
- AC groups: per-block nzeros + coefficient tokens in natural order
  (dec_group.cc:453-530), dequant with AdjustQuantBias + CfL
  (dec_group.cc:96-165), inverse transform.

Round-1 encoder: DCT8-only strategy, uniform quant field, CfL maps = 0,
444, XYB, single pass, adaptive DC smoothing skipped. Decoder handles all
strategies and per-tile CfL.
"""

from __future__ import annotations

import functools

import numpy as np

from ..base.device import span
from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from ..io.fields import (
    Bits,
    BitsOffset,
    Bundle,
    U32Enc,
    Val,
    f16_read,
    f16_write,
    u32_read,
    u32_write,
)
from ..io.frame_header import (
    FLAG_NOISE,
    FLAG_PATCHES,
    FLAG_SPLINES,
    FLAG_SKIP_ADAPTIVE_DC_SMOOTHING,
    FLAG_USE_DC_FRAME,
    FrameDimensions,
    FrameHeader,
)
from ..io.headers import DEFAULT_QUANT_BIAS
from ..entropy.decode import ANSSymbolReader, decode_histograms
from ..entropy.encode import (Token, TokenArray, build_and_encode_histograms,
                              write_tokens)
from ..modular.codec import GroupHeader, ModularOptions, _tokenize_channel, modular_decode
from ..modular.image import Channel, ModularImage
from ..modular.predict import P_GRADIENT
from ..modular.tree import encode_tree, make_fixed_tree, num_tree_contexts
from . import ac_strategy as acs
from .ctx import (
    COEFF_FREQ_CONTEXT,
    COEFF_NUM_NONZERO_CONTEXT,
    ZERO_DENSITY_CONTEXT_COUNT,
    BlockCtxMap,
    decode_block_ctx_map,
    predict_nzeros,
    zero_density_context,
    QUANT_MAX,
)
from .quant_weights import DequantMatrices
from .transforms import (
    dc_from_lowest_frequencies,
    lowest_frequencies_from_dc,
    transform_from_pixels,
    transform_to_pixels,
)

GLOBAL_SCALE_DENOM = 1 << 16  # quantizer.h:32
GLOBAL_SCALE_NUMER = 4096
COLOR_TILE_DIM_IN_BLOCKS = 8
DEFAULT_COLOR_FACTOR = 84
Y_TO_B_BASE = 1.0  # cms::kYToBRatio

# encoder quality constants (enc_adaptive_quantization.cc)
K_AC_QUANT = 0.79
K_DC_QUANT = 1.095924047623553
# global-scale anchor for the adaptive-field path outside the
# Butteraugli loop (enc_heuristics.cc:1115 "q = 0.39 / distance")
K_GLOBAL_SCALE_QUANT = 0.39


def initial_quant_dc(distance: float) -> float:
    """InitialQuantDC (enc_adaptive_quantization.cc:1251-1263)."""
    k_dc_mul = 0.3
    distance = max(distance, 1e-4)
    bt_dc = max(0.5 * distance,
                min(distance,
                    k_dc_mul * (distance / k_dc_mul) ** 0.83))
    return min(K_DC_QUANT / bt_dc, 50.0)

ORDER_ENC = U32Enc(Val(0x5F), Val(0x13), Val(0), Bits(acs.NUM_ORDERS))


class QuantizerParams(Bundle):
    """quantizer.cc:119-127."""

    def visit_fields(self, v):
        v.u32(self, U32Enc(BitsOffset(11, 1), BitsOffset(11, 2049),
                           BitsOffset(12, 4097), BitsOffset(16, 8193)),
              1, "global_scale")
        v.u32(self, U32Enc(Val(16), BitsOffset(5, 1), BitsOffset(8, 1),
                           BitsOffset(16, 1)), 1, "quant_dc")


class Quantizer:
    """quantizer.h:64-148."""

    def __init__(self, dequant: DequantMatrices, quant_dc: int = 64,
                 global_scale: int = 64):
        self.dequant = dequant
        self.quant_dc = quant_dc
        self.global_scale = global_scale
        self._recompute()

    def _recompute(self):
        self.global_scale_float = self.global_scale / GLOBAL_SCALE_DENOM
        self.inv_global_scale = GLOBAL_SCALE_DENOM / self.global_scale
        self.inv_quant_dc = self.inv_global_scale / self.quant_dc

    def compute_global_scale_and_quant(self, quant_dc: float,
                                       quant_median: float):
        """quantizer.cc:39-69."""
        k_target = 5.0
        scale = GLOBAL_SCALE_DENOM * quant_median / k_target
        scale = min(max(scale, 1.0), 1 << 15)
        new_global_scale = int(scale)
        scaled_quant_dc = int(quant_dc * GLOBAL_SCALE_NUMER * 1.6)
        if new_global_scale > scaled_quant_dc:
            new_global_scale = max(scaled_quant_dc, 1)
        self.global_scale = new_global_scale
        self._recompute()
        fval = quant_dc * self.inv_global_scale + 0.5
        self.quant_dc = int(min(1 << 16, fval))
        self._recompute()

    def mul_dc(self, c: int) -> float:
        return self.inv_quant_dc * self.dequant.dc_quant[c]

    def decode(self, r: BitReader):
        p = QuantizerParams().read(r)
        self.global_scale = p.global_scale
        self.quant_dc = p.quant_dc
        self._recompute()

    def encode(self, w: BitWriter):
        p = QuantizerParams()
        p.global_scale = self.global_scale
        p.quant_dc = self.quant_dc
        p.write(w)


def adjust_quant_bias(q: np.ndarray, c: int, dtype=None) -> np.ndarray:
    """AdjustQuantBias (quantizer-inl.h:34-62), vectorized.

    dtype-following: float32 input (encode path) stays float32; integer
    coefficients (decode path) compute in float64 unless `dtype` asks
    for the reference's float32."""
    biases = DEFAULT_QUANT_BIAS
    qf = q.astype(dtype if dtype is not None else
                  (np.float32 if q.dtype == np.float32 else np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        general = qf - biases[3] / np.where(qf == 0, 1, qf)
    return np.where(q == 0, 0.0,
                    np.where(q == 1, biases[c],
                             np.where(q == -1, -biases[c], general)))


class VarDCTState:
    """Per-frame decoder/encoder shared state (PassesSharedState analog)."""

    def __init__(self, fh: FrameHeader, fd: FrameDimensions,
                 alloc_xyb: bool = True):
        self.fh = fh
        self.fd = fd
        self.matrices = DequantMatrices()
        self.quantizer = Quantizer(self.matrices)
        self.block_ctx_map = BlockCtxMap()
        # CfL; non-XYB frames have base correlation 0
        # (ColorCorrelationMap::Create, chroma_from_luma.cc:53-55)
        from ..io.frame_header import CT_XYB as _CT_XYB

        self.color_factor = DEFAULT_COLOR_FACTOR
        self.base_x = 0.0
        self.base_b = Y_TO_B_BASE if fh.color_transform == _CT_XYB else 0.0
        self.ytox_dc = 0
        self.ytob_dc = 0
        tile_w = -(-fd.xsize_blocks // COLOR_TILE_DIM_IN_BLOCKS)
        tile_h = -(-fd.ysize_blocks // COLOR_TILE_DIM_IN_BLOCKS)
        self.ytox_map = np.zeros((tile_h, tile_w), dtype=np.int32)
        self.ytob_map = np.zeros((tile_h, tile_w), dtype=np.int32)
        # per-block fields
        self.raw_quant_field = np.ones(
            (fd.ysize_blocks, fd.xsize_blocks), dtype=np.int32)
        self.epf_sharpness = np.zeros(
            (fd.ysize_blocks, fd.xsize_blocks), dtype=np.int32)
        # strategy: raw id per 8x8 block; origin flag
        self.strategy = np.full((fd.ysize_blocks, fd.xsize_blocks), -1,
                                dtype=np.int32)
        self.is_origin = np.zeros((fd.ysize_blocks, fd.xsize_blocks),
                                  dtype=bool)
        self.dc = np.zeros((3, fd.ysize_blocks, fd.xsize_blocks),
                           dtype=np.float64)
        self.quant_dc_img = np.zeros((fd.ysize_blocks, fd.xsize_blocks),
                                     dtype=np.int32)
        # decoded XYB image (the low-memory strip decoder never
        # materializes it; see vardct/low_memory.py). float32 like the
        # reference's render pipeline (dec_group.cc / Image3F)
        self.xyb = None if not alloc_xyb else np.zeros(
            (3, fd.ysize_padded, fd.xsize_padded), dtype=np.float32)
        self.x_dm_mult = (1 / 1.25) ** (fh.x_qm_scale - 2.0)
        self.b_dm_mult = (1 / 1.25) ** (fh.b_qm_scale - 2.0)
        # modular substream codec state (global tree)
        self.tree = None
        self.code = None
        self.context_map = None
        self.num_histograms = 1
        self.ac_code = []       # per pass
        self.ac_context_map = []
        self.orders = []        # per pass: {(ord, c): order} (custom only)
        self.noise_lut = None
        self.splines = None
        self.patches = None
        self.qblocks = {}       # (by, bx) -> (3, cb*64) accumulated ints

    def ytox(self, tile_val: int) -> float:
        return self.base_x + tile_val / self.color_factor

    def ytob(self, tile_val: int) -> float:
        return self.base_b + tile_val / self.color_factor

    def cfl_dc_factors(self):
        return (self.ytox(self.ytox_dc), self.ytob(self.ytob_dc))


def adaptive_dc_smoothing(dc: np.ndarray, dc_factors) -> np.ndarray:
    """AdaptiveDCSmoothing (compressed_dc.cc:46-196), vectorized.

    dc: (3, nby, nbx); dc_factors: per-channel DC quantization step.
    Smooths DC values toward a 3x3 weighted average where the change stays
    below ~0.5 DC quantization steps (gap-gated blend)."""
    _, h, w = dc.shape
    if h <= 2 or w <= 2:
        return dc
    w1 = 0.20345139757231578
    w2 = 0.0334829185968739
    w0 = 1.0 - 4.0 * (w1 + w2)
    p = np.pad(dc, ((0, 0), (1, 1), (1, 1)), mode="edge")

    def sh(dy, dx):
        return p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    corner = sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1)
    side = sh(0, -1) + sh(0, 1) + sh(-1, 0) + sh(1, 0)
    sm = corner * w2 + side * w1 + dc * w0
    fac = np.asarray(dc_factors, dtype=np.float64)[:, None, None]
    gap = np.maximum(0.5, np.abs((dc - sm) / fac).max(axis=0))
    factor = np.maximum(0.0, -4.0 * gap + 3.0)
    out = dc + (sm - dc) * factor[None]
    # borders are copied unsmoothed (compressed_dc.cc:139-170)
    out[:, 0, :] = dc[:, 0, :]
    out[:, -1, :] = dc[:, -1, :]
    out[:, :, 0] = dc[:, :, 0]
    out[:, :, -1] = dc[:, :, -1]
    return out


def decode_cmap_dc(r: BitReader, state: VarDCTState) -> None:
    """ColorCorrelation::DecodeDC (chroma_from_luma.cc:20-40)."""
    if r.read_bits(1):
        return
    state.color_factor = u32_read(
        U32Enc(Val(DEFAULT_COLOR_FACTOR), Val(256), BitsOffset(8, 2),
               BitsOffset(16, 258)), r)
    state.base_x = f16_read(r)
    state.base_b = f16_read(r)
    if abs(state.base_x) > 4.0 or abs(state.base_b) > 4.0:
        raise JXLError("base correlation out of range")
    state.ytox_dc = r.read_bits(8) - 128
    state.ytob_dc = r.read_bits(8) - 128


def encode_cmap_dc_default(w: BitWriter) -> None:
    w.write(1, 1)


# ------------------------------------------------------------------ AC groups
def _block_list(state: VarDCTState, gx: int, gy: int):
    """Blocks of a group in raster order: (bx_in_group, by_in_group,
    strategy)."""
    fd = state.fd
    bx0 = gx * (fd.group_dim // 8)
    by0 = gy * (fd.group_dim // 8)
    bw = min(fd.group_dim // 8, fd.xsize_blocks - bx0)
    bh = min(fd.group_dim // 8, fd.ysize_blocks - by0)
    out = []
    for by in range(bh):
        for bx in range(bw):
            if state.is_origin[by0 + by, bx0 + bx]:
                out.append((bx, by, int(state.strategy[by0 + by, bx0 + bx])))
    return out, bx0, by0, bw, bh


def _decode_ac_group_native(r: BitReader, state: VarDCTState, reader,
                            blocks, bx0: int, by0: int, bw: int, bh: int,
                            ctx_offset: int, shift: int,
                            pass_idx: int) -> bool:
    """Whole-group AC decode in C (native/vardct_decode.c); returns False
    to fall back to the Python token loop."""
    from ..native_ext import NativeCodes, decode_ac_group_native, get_lib

    lib = get_lib()
    if lib is None:
        return False
    code = state.ac_code[pass_idx]
    cmap = state.ac_context_map[pass_idx]
    ncodes = getattr(code, "_native_codes", None)
    if ncodes is None or ncodes.context_map_src is not cmap:
        ncodes = NativeCodes(code, cmap)
        ncodes.context_map_src = cmap
        code._native_codes = ncodes
    bcm = state.block_ctx_map
    key = (bx0, by0)
    cache = getattr(state, "_ac_native", None)
    if cache is None:
        cache = state._ac_native = {}
    prep = cache.get(key)
    if prep is None:
        n = len(blocks)
        bxa = np.fromiter((b[0] for b in blocks), np.int32, n)
        bya = np.fromiter((b[1] for b in blocks), np.int32, n)
        strat = np.fromiter((b[2] for b in blocks), np.int32, n)
        cxa = np.asarray(acs.COVERED_X, np.int32)[strat]
        cya = np.asarray(acs.COVERED_Y, np.int32)[strat]
        l2a = np.asarray(acs.LOG2_COVERED, np.int32)[strat]
        sizea = (cxa * cya * 64).astype(np.int32)
        orda = np.asarray(acs.STRATEGY_ORDER, np.int32)[strat]
        quant = state.raw_quant_field[by0 + bya, bx0 + bxa].astype(np.int64)
        # vectorized BlockCtxMap.context (ac_context.h:85-148), dc_idx = 0
        qft = np.asarray(bcm.qf_thresholds, np.int64)
        qf_idx = (quant[:, None] > qft[None, :]).sum(axis=1) \
            if len(qft) else np.zeros(len(quant), np.int64)
        cmap_arr = np.asarray(bcm.ctx_map, np.int32)
        bctx = np.empty((n, 3), dtype=np.int32)
        from .ac_strategy import NUM_ORDERS
        for c in range(3):
            cidx = (c ^ 1) if c < 2 else 2
            idx = ((cidx * NUM_ORDERS + orda) * (len(qft) + 1) + qf_idx) \
                * bcm.num_dc_ctxs
            bctx[:, c] = cmap_arr[idx]
        out_off = np.zeros(n, dtype=np.int64)
        np.cumsum(3 * sizea[:-1], out=out_off[1:])
        total = int(out_off[-1] + 3 * sizea[-1]) if n else 0
        out_flat = np.zeros(total, dtype=np.int32)
        prep = dict(bx=bxa, by=bya, cx=cxa, cy=cya, log2cb=l2a, size=sizea,
                    bctx=np.ascontiguousarray(bctx), strat=strat, orda=orda,
                    out_off=out_off, out_flat=out_flat, pass_orders={})
        cache[key] = prep
        # expose per-block views through the regular qblocks dict
        for i, (bx, by, _s) in enumerate(blocks):
            o = int(out_off[i])
            state.qblocks[(by0 + by, bx0 + bx)] = \
                out_flat[o:o + 3 * sizea[i]].reshape(3, int(sizea[i]))
    if pass_idx not in prep["pass_orders"]:
        # coefficient orders: one entry per (order class, channel); custom
        # orders are signaled per pass
        pass_orders = state.orders[pass_idx] \
            if pass_idx < len(state.orders) else {}
        strat, orda = prep["strat"], prep["orda"]
        order_chunks = []
        order_pos = {}
        pos = 0
        for o in np.unique(orda):
            for c in range(3):
                arr = pass_orders.get((int(o), c))
                if arr is None:
                    s_first = int(strat[orda == o][0])
                    arr = acs.natural_coeff_order(s_first)
                arr = np.ascontiguousarray(arr, dtype=np.int32)
                order_chunks.append(arr)
                order_pos[(int(o), c)] = pos
                pos += len(arr)
        orders_flat = np.concatenate(order_chunks) if order_chunks \
            else np.zeros(1, np.int32)
        n = len(orda)
        order_off = np.empty((n, 3), dtype=np.int64)
        for c in range(3):
            order_off[:, c] = [order_pos[(int(o), c)] for o in orda]
        prep["pass_orders"][pass_idx] = (
            orders_flat, np.ascontiguousarray(order_off))
    orders_flat, order_off = prep["pass_orders"][pass_idx]
    call = dict(prep)
    call["orders_flat"] = orders_flat
    call["order_off"] = order_off
    bitpos, fstate = decode_ac_group_native(
        lib, r.data, r.total_bits_consumed(), reader.state, ncodes, call,
        bw, bh, ctx_offset, shift, bcm.num_ctxs, prep["out_flat"])
    r.seek_bits(bitpos)
    reader.state = fstate
    return True


def _bctx_luts(bcm):
    """Block-context LUT over (c_idx, order class, qf bucket) plus the
    qf thresholds, in the layout native/vardct_{decode,encode}.c walk."""
    nqf = len(bcm.qf_thresholds)
    cmap_arr = np.asarray(bcm.ctx_map, np.int32)
    bctx_lut = np.empty((3, acs.NUM_ORDERS, nqf + 1), dtype=np.int32)
    for cidx in range(3):
        for o in range(acs.NUM_ORDERS):
            for qi in range(nqf + 1):
                bctx_lut[cidx, o, qi] = cmap_arr[
                    ((cidx * acs.NUM_ORDERS + o) * (nqf + 1) + qi)
                    * bcm.num_dc_ctxs]
    qf_thr = np.asarray(bcm.qf_thresholds, dtype=np.int64)
    return np.ascontiguousarray(bctx_lut), qf_thr


def _order_image_luts(used_strategies, order_lookup, w):
    """Image-relative coefficient-order LUTs per (strategy, channel):
    order_lookup(ord_class, c) -> order array or None (natural order).
    Returns (off_tab i64[NUM_STRATEGIES, 3], oflat i32[...])."""
    chunks, off_tab = [], np.zeros((acs.NUM_STRATEGIES, 3),
                                   dtype=np.int64)
    pos = 0
    for s in used_strategies:
        s = int(s)
        # qimg stores each tile as the wide-layout vector reshaped
        # row-major to the tile shape (cy*8, cx*8)
        cols = acs.COVERED_X[s] * 8
        for c in range(3):
            order = order_lookup(acs.STRATEGY_ORDER[s], c)
            if order is None:
                order = acs.natural_coeff_order(s)
            order = np.asarray(order, dtype=np.int64)
            oimg = ((order // cols) * w + order % cols).astype(np.int32)
            chunks.append(oimg)
            off_tab[s, c] = pos
            pos += len(oimg)
    oflat = np.concatenate(chunks) if chunks else np.zeros(1, np.int32)
    return np.ascontiguousarray(off_tab), oflat


_GEOM_LUTS = None


def _geometry_luts():
    global _GEOM_LUTS
    if _GEOM_LUTS is None:
        _GEOM_LUTS = (np.asarray(acs.COVERED_X, np.int32),
                      np.asarray(acs.COVERED_Y, np.int32),
                      np.asarray(acs.LOG2_COVERED, np.int32),
                      np.asarray(acs.STRATEGY_ORDER, np.int32))
    return _GEOM_LUTS


def decode_ac_bulk_native(state: VarDCTState, data: bytes,
                          per_pass) -> bool:
    """Whole-image AC decode: one C call per pass over every group
    section, coefficients written straight into dense image-layout planes
    (state.qimg, i32[3, nby*8, nbx*8]). Populated only on the device
    decode path (state.want_qimg); state.qblocks stays empty."""
    from ..native_ext import (NativeCodes, decode_ac_image_native, get_lib)

    lib = get_lib()
    if lib is None:
        return False
    for code in state.ac_code:
        if code.lz77.enabled or code.use_prefix_code:
            return False
    fd = state.fd
    nby, nbx = fd.ysize_blocks, fd.xsize_blocks
    h, w = nby * 8, nbx * 8
    bcm = state.block_ctx_map
    nqf = len(bcm.qf_thresholds)
    if bcm.num_dc_ctxs != 1:
        return False  # dc-conditioned block contexts: rare; python path
    histo_bits = (state.num_histograms - 1).bit_length() \
        if state.num_histograms > 1 else 0
    bctx_lut, qf_thr = _bctx_luts(bcm)
    cov_x, cov_y, log2cb, ord_lut = _geometry_luts()
    used_strategies = np.unique(state.strategy[state.is_origin])
    qimg = np.zeros((3, h, w), dtype=np.int32)
    planes = [qimg[0], qimg[1], qimg[2]]
    state.qimg = qimg
    for p, (offs, sizes) in enumerate(per_pass):
        pass_orders = state.orders[p] if p < len(state.orders) else {}
        off_tab, oflat = _order_image_luts(
            used_strategies,
            lambda o, c: pass_orders.get((o, c)), w)
        shift = state.fh.passes.shift[p] \
            if state.fh.passes.num_passes > 1 else 0
        code = state.ac_code[p]
        cmap = state.ac_context_map[p]
        ncodes = getattr(code, "_native_codes", None)
        if ncodes is None or ncodes.context_map_src is not cmap:
            ncodes = NativeCodes(code, cmap)
            ncodes.context_map_src = cmap
            code._native_codes = ncodes
        import os

        n_threads = min(len(offs), getattr(state, "num_threads", 0)
                        or (os.cpu_count() or 1))
        rc = decode_ac_image_native(
            lib, data, np.asarray(offs, dtype=np.uint64),
            np.asarray(sizes, dtype=np.uint64), fd.xsize_groups,
            fd.group_dim // 8, ncodes,
            (state.strategy, state.is_origin, state.raw_quant_field),
            (bctx_lut, qf_thr, off_tab, oflat,
             cov_x, cov_y, log2cb, ord_lut),
            histo_bits, state.num_histograms, bcm.num_ac_contexts(),
            bcm.num_ctxs, shift, planes, n_threads=n_threads)
        if rc != 0:
            raise JXLError(f"invalid AC stream (group {rc - 1000}, "
                           f"pass {p})")
    return True


def decode_ac_group(r: BitReader, state: VarDCTState, group_idx: int,
                    pass_idx: int = 0) -> None:
    """Read one group x pass section: accumulate quantized coefficients
    (DecodeACVarBlock, dec_group.cc:453-530)."""
    fd = state.fd
    gx = group_idx % fd.xsize_groups
    gy = group_idx // fd.xsize_groups
    blocks, bx0, by0, bw, bh = _block_list(state, gx, gy)
    histo_bits = (state.num_histograms - 1).bit_length() \
        if state.num_histograms > 1 else 0
    ctx_offset = 0
    if histo_bits:
        sel = r.read_bits(histo_bits)
        if sel >= state.num_histograms:
            raise JXLError("AC group histogram selector out of range")
        ctx_offset = sel * state.block_ctx_map.num_ac_contexts()
    code = state.ac_code[pass_idx]
    cmap = state.ac_context_map[pass_idx]
    shift = state.fh.passes.shift[pass_idx] \
        if state.fh.passes.num_passes > 1 else 0
    reader = ANSSymbolReader(code, r)
    if not code.lz77.enabled and not code.use_prefix_code and blocks:
        if _decode_ac_group_native(r, state, reader, blocks, bx0, by0,
                                   bw, bh, ctx_offset, shift, pass_idx):
            if not reader.check_final_state():
                raise JXLError("AC group ANS final state mismatch")
            return
    nzeros_map = np.zeros((3, bh, bw), dtype=np.int32)
    bcm = state.block_ctx_map
    pass_orders = state.orders[pass_idx] if pass_idx < len(state.orders) \
        else {}
    for (bx, by, strategy) in blocks:
        cx, cy = acs.COVERED_X[strategy], acs.COVERED_Y[strategy]
        cb = cx * cy
        log2_cb = acs.LOG2_COVERED[strategy]
        size = cb * 64
        ord_ = acs.STRATEGY_ORDER[strategy]
        quant = int(state.raw_quant_field[by0 + by, bx0 + bx])
        key = (by0 + by, bx0 + bx)
        if key not in state.qblocks:
            state.qblocks[key] = np.zeros((3, size), dtype=np.int64)
        acc = state.qblocks[key]
        for c in (1, 0, 2):
            order = pass_orders.get((ord_, c))
            if order is None:
                order = acs.natural_coeff_order(strategy)
            qblock = acc[c]
            pred = predict_nzeros(nzeros_map, c, by, bx)
            block_ctx = bcm.context(0, quant, ord_, c)
            nz_ctx = ctx_offset + bcm.nonzero_context(pred, block_ctx)
            nzeros = reader.read_hybrid_uint(nz_ctx, r, cmap)
            if nzeros > size - cb:
                raise JXLError("invalid AC nzeros")
            nzeros_map[c, by:by + cy, bx:bx + cx] = \
                (nzeros + cb - 1) >> log2_cb
            histo_offset = ctx_offset + bcm.zero_density_contexts_offset(
                block_ctx)
            prev = 0 if nzeros > size // 16 else 1
            k = cb
            remaining = nzeros
            while k < size and remaining != 0:
                zctx = zero_density_context(remaining, k, cb, log2_cb,
                                            prev)
                if zctx >= ZERO_DENSITY_CONTEXT_COUNT:
                    # lying nzeros: more remaining than positions left
                    raise JXLError("invalid AC zero-density context")
                ctx = histo_offset + zctx
                u = reader.read_hybrid_uint(ctx, r, cmap)
                if u >= (1 << 27):
                    # coefficients this large cannot come from a real
                    # quantizer and would overflow the native path's
                    # int32 accumulation (kept bit-compatible)
                    raise JXLError("invalid AC coefficient magnitude")
                # UnpackSigned: even -> u/2, odd -> -((u+1)/2)
                coeff = (u >> 1) if (u & 1) == 0 else -((u + 1) >> 1)
                qblock[order[k]] += coeff << shift if coeff >= 0 \
                    else -((-coeff) << shift)
                prev = 1 if u else 0
                remaining -= prev
                k += 1
            if remaining != 0:
                raise JXLError("invalid AC block: leftover nzeros")
    if not reader.check_final_state():
        raise JXLError("AC group ANS final state mismatch")


def render_groups(state: VarDCTState) -> None:
    """Dequant + LLF-from-DC + inverse transform for every block
    (DequantBlock + TransformToPixels, dec_group.cc:96-165, 380-440).
    DCT8 blocks — the vast majority — run as ONE batched dequant +
    einsum IDCT; other strategies fall back to the per-block path."""
    fd = state.fd
    inv_gs = state.quantizer.inv_global_scale
    qimg = getattr(state, "qimg", None)
    if state.qblocks or qimg is None:
        qimg = None
        ys_all = np.fromiter((k[0] for k in state.qblocks), np.int64,
                             len(state.qblocks))
        xs_all = np.fromiter((k[1] for k in state.qblocks), np.int64,
                             len(state.qblocks))

        def fetch(k):
            return state.qblocks[k]
    else:
        # the bulk C decoder left the coefficients in dense image
        # layout: each tile holds its wide-layout vector reshaped
        # row-major to the covered rect (decode_ac_bulk_native)
        orig = np.argwhere(state.is_origin)
        ys_all, xs_all = orig[:, 0], orig[:, 1]

        def fetch(k):
            by, bx = k
            s = int(state.strategy[by, bx])
            cy, cx = acs.COVERED_Y[s], acs.COVERED_X[s]
            return qimg[:, by * 8:(by + cy) * 8,
                        bx * 8:(bx + cx) * 8].reshape(3, -1)
    svals = state.strategy[ys_all, xs_all]
    batched = set()
    for s in np.unique(svals):
        s = int(s)
        sel = svals == s
        if s in _PLAIN_DCT_STRATEGIES and int(sel.sum()) > 8:
            _render_dct_batch(state, s, (ys_all[sel], xs_all[sel]),
                              inv_gs, qimg=qimg)
            batched.add(s)
    rem = ~np.isin(svals, list(batched)) if batched \
        else np.ones(len(svals), dtype=bool)
    remaining = (((by, bx), fetch((by, bx)))
                 for by, bx in zip(ys_all[rem], xs_all[rem]))
    for (aby, abx), qblocks in remaining:
        strategy = int(state.strategy[aby, abx])
        cx, cy = acs.COVERED_X[strategy], acs.COVERED_Y[strategy]
        kind = acs.QUANT_TABLE[strategy]
        quant = int(state.raw_quant_field[aby, abx])
        tile_x = abx // COLOR_TILE_DIM_IN_BLOCKS
        tile_y = aby // COLOR_TILE_DIM_IN_BLOCKS
        x_cc = state.ytox(int(state.ytox_map[tile_y, tile_x]))
        b_cc = state.ytob(int(state.ytob_map[tile_y, tile_x]))
        scaled = inv_gs / quant
        rows = min(cy, cx) * 8
        cols = max(cy, cx) * 8
        dm = [state.matrices.dequant_matrix(kind, c).reshape(-1)
              for c in range(3)]
        dq_y = adjust_quant_bias(qblocks[1], 1) * dm[1] * scaled
        dq_x = adjust_quant_bias(qblocks[0], 0) * dm[0] * (
            scaled * state.x_dm_mult) + x_cc * dq_y
        dq_b = adjust_quant_bias(qblocks[2], 2) * dm[2] * (
            scaled * state.b_dm_mult) + b_cc * dq_y
        coeffs = np.stack([dq_x, dq_y, dq_b]).reshape(3, rows, cols)
        dc_block = state.dc[:, aby:aby + cy, abx:abx + cx]
        for c in range(3):
            llf = lowest_frequencies_from_dc(strategy, dc_block[c])
            coeffs[c, :llf.shape[0], :llf.shape[1]] = llf
        for c in range(3):
            pix = transform_to_pixels(strategy, coeffs[c])
            y0 = aby * 8
            x0 = abx * 8
            state.xyb[c, y0:y0 + cy * 8, x0:x0 + cx * 8] = pix


_PLAIN_DCT_STRATEGIES = frozenset({
    acs.DCT, acs.DCT16X16, acs.DCT32X32, acs.DCT64X64, acs.DCT128X128,
    acs.DCT256X256, acs.DCT16X8, acs.DCT8X16, acs.DCT32X8, acs.DCT8X32,
    acs.DCT32X16, acs.DCT16X32, acs.DCT64X32, acs.DCT32X64,
    acs.DCT128X64, acs.DCT64X128, acs.DCT256X128, acs.DCT128X256})


def _render_dct_batch(state: VarDCTState, strategy: int, keys,
                      inv_gs, qimg=None) -> None:
    """Batched dequant + LLF + IDCT for all blocks of one plain-DCT
    strategy: one einsum instead of a per-block call (the per-call
    numpy overhead dominates host decode otherwise). qimg: dense
    image-layout coefficients from the bulk C decode — blocks are
    gathered from it instead of state.qblocks."""
    from ..ops.dct import idct2d, dct2d
    from .transforms import resample_scales

    cx, cy = acs.COVERED_X[strategy], acs.COVERED_Y[strategy]
    rows, cols = cy * 8, cx * 8
    kind = acs.QUANT_TABLE[strategy]
    if isinstance(keys, tuple):  # (ys, xs) array pair from render_groups
        ys, xs = keys
        n = len(ys)
        keys = None
    else:
        n = len(keys)
        ys = np.fromiter((k[0] for k in keys), np.int64, n)
        xs = np.fromiter((k[1] for k in keys), np.int64, n)
    if qimg is not None and cy == 1 and cx == 1:
        from ..native_ext import dequant_dct8_native, get_lib

        ty = ys // COLOR_TILE_DIM_IN_BLOCKS
        tx = xs // COLOR_TILE_DIM_IN_BLOCKS
        x_cc_n = state.ytox(state.ytox_map[ty, tx].astype(np.float32))
        b_cc_n = state.ytob(state.ytob_map[ty, tx].astype(np.float32))
        co_c = dequant_dct8_native(
            get_lib(), qimg, ys, xs, state.raw_quant_field,
            np.stack([state.matrices.dequant_matrix(kind, c).reshape(-1)
                      for c in range(3)]), float(inv_gs),
            float(state.x_dm_mult), float(state.b_dm_mult),
            x_cc_n, b_cc_n, state.dc, DEFAULT_QUANT_BIAS)
        if co_c is not None:
            from ..ops.dct import idct2d

            pix = idct2d(co_c.reshape(n, 3, 8, 8), 8, 8)
            h8, w8 = state.xyb.shape[1] // 8, state.xyb.shape[2] // 8
            xyb5 = state.xyb.reshape(3, h8, 8, w8, 8)
            xyb5[:, ys, :, xs, :] = pix
            return
        blk = qimg.reshape(3, state.fd.ysize_blocks, 8,
                           state.fd.xsize_blocks, 8)
        # separated advanced indices put the block axis first: (n,3,8,8)
        q = blk[:, ys, :, xs, :].reshape(n, 3, 64)
    elif qimg is not None:
        q = np.stack([qimg[:, y * 8:(y + cy) * 8,
                           x * 8:(x + cx) * 8].reshape(3, -1)
                      for y, x in zip(ys, xs)])
    else:
        q = np.stack([state.qblocks[(int(y), int(x))]
                      for y, x in zip(ys, xs)])  # (n, 3, size)
    quant = state.raw_quant_field[ys, xs].astype(np.float32)
    scaled = (np.float32(inv_gs) / quant)[:, None]
    ty = ys // COLOR_TILE_DIM_IN_BLOCKS
    tx = xs // COLOR_TILE_DIM_IN_BLOCKS
    x_cc = state.ytox(state.ytox_map[ty, tx].astype(np.float32))[:, None]
    b_cc = state.ytob(state.ytob_map[ty, tx].astype(np.float32))[:, None]
    dm = np.stack([state.matrices.dequant_matrix(kind, c).reshape(-1)
                   for c in range(3)]).astype(np.float32)
    f32 = np.float32
    dq_y = adjust_quant_bias(q[:, 1], 1, f32) * dm[1] * scaled
    dq_x = adjust_quant_bias(q[:, 0], 0, f32) * dm[0] * (
        scaled * f32(state.x_dm_mult)) + x_cc.astype(f32) * dq_y
    dq_b = adjust_quant_bias(q[:, 2], 2, f32) * dm[2] * (
        scaled * f32(state.b_dm_mult)) + b_cc.astype(f32) * dq_y
    wr, wc = min(rows, cols), max(rows, cols)
    co = np.stack([dq_x, dq_y, dq_b], axis=1).reshape(n, 3, wr, wc)
    # batched LowestFrequenciesFromDC
    if cy == 1 and cx == 1:
        co[:, :, 0, 0] = state.dc[:, ys, xs].T  # (n, 3) gather
    else:
        dc_batch = np.stack([state.dc[:, y:y + cy, x:x + cx]
                             for y, x in zip(ys, xs)])  # (n, 3, cy, cx)
        llf = dct2d(dc_batch.astype(np.float32))
        lh, lw = llf.shape[-2:]
        sy = resample_scales(lh, lh * 8)
        sx = resample_scales(lw, lw * 8)
        co[:, :, :lh, :lw] = llf / (sy[:, None] * sx[None, :])
    pix = idct2d(co, rows, cols)  # (n, 3, rows, cols)
    if cy == 1 and cx == 1:
        h8, w8 = state.xyb.shape[1] // 8, state.xyb.shape[2] // 8
        xyb5 = state.xyb.reshape(3, h8, 8, w8, 8)
        # separated advanced indices move the block axis to the front:
        # the indexing result is (n, 3, 8, 8), matching pix directly
        xyb5[:, ys, :, xs, :] = pix
    else:
        for i, (aby, abx) in enumerate(zip(ys, xs)):
            state.xyb[:, aby * 8:aby * 8 + rows,
                      abx * 8:abx * 8 + cols] = pix[i]


def tokenize_ac_group(state: VarDCTState, group_idx: int, coeffs_q,
                      orders: dict = None):
    """Encoder counterpart of decode_ac_group: produces tokens.

    coeffs_q: dict (by_abs, bx_abs) -> (3, size) quantized int arrays in
    coefficient (wide raster) layout.
    orders: optional {(ord, c): order} custom coefficient orders.
    """
    fd = state.fd
    gx = group_idx % fd.xsize_groups
    gy = group_idx // fd.xsize_groups
    blocks, bx0, by0, bw, bh = _block_list(state, gx, gy)
    bcm = state.block_ctx_map
    nzeros_map = np.zeros((3, bh, bw), dtype=np.int32)
    orders = orders or {}
    tokens = []
    for (bx, by, strategy) in blocks:
        cx, cy = acs.COVERED_X[strategy], acs.COVERED_Y[strategy]
        cb = cx * cy
        log2_cb = acs.LOG2_COVERED[strategy]
        size = cb * 64
        ord_ = acs.STRATEGY_ORDER[strategy]
        quant = int(state.raw_quant_field[by0 + by, bx0 + bx])
        qblocks = coeffs_q[(by0 + by, bx0 + bx)]
        for c in (1, 0, 2):
            order = orders.get((ord_, c))
            if order is None:
                order = acs.natural_coeff_order(strategy)
            vals = qblocks[c].reshape(-1)[order[cb:]].astype(np.int64)
            nz_mask = vals != 0
            nzeros = int(nz_mask.sum())
            pred = predict_nzeros(nzeros_map, c, by, bx)
            block_ctx = bcm.context(0, quant, ord_, c)
            nz_ctx = bcm.nonzero_context(pred, block_ctx)
            tokens.append(Token(nz_ctx, nzeros))
            nzeros_map[c, by:by + cy, bx:bx + cx] = (nzeros + cb - 1) >> log2_cb
            if nzeros == 0:
                continue
            # vectorized zero-density chain (the decode_ac loop inverse):
            # tokens run through the last nonzero coefficient
            histo_offset = bcm.zero_density_contexts_offset(block_ctx)
            stop = int(np.flatnonzero(nz_mask)[-1]) + 1
            v = vals[:stop]
            m = nz_mask[:stop]
            u = np.where(v >= 0, v << 1, -v * 2 - 1)
            rem = nzeros - np.concatenate(
                ([0], np.cumsum(m[:-1], dtype=np.int64)))
            prev = np.empty(stop, dtype=np.int64)
            prev[0] = 0 if nzeros > size // 16 else 1
            if stop > 1:
                prev[1:] = m[:-1]
            nzl = (rem + cb - 1) >> log2_cb
            ks = np.arange(cb, cb + stop, dtype=np.int64) >> log2_cb
            ctx = histo_offset + (COEFF_NUM_NONZERO_CONTEXT[nzl]
                                  + COEFF_FREQ_CONTEXT[ks]) * 2 + prev
            tokens.append(TokenArray(ctx.astype(np.int32), u))
    return tokens


# ------------------------------------------------------- DC + metadata streams
def _num_quant_tables():
    return acs.NUM_QUANT_TABLES


def _modular_stream_ids(fd: FrameDimensions):
    """ModularStreamId::ID mapping (dec_modular.h:44-67)."""
    def vardct_dc(g):
        return 1 + g

    def modular_dc(g):
        return 1 + fd.num_dc_groups + g

    def ac_metadata(g):
        return 1 + 2 * fd.num_dc_groups + g

    return vardct_dc, modular_dc, ac_metadata


def decode_dc_group(r: BitReader, state: VarDCTState, dc_group_id: int) -> None:
    """ProcessDCGroup for VarDCT (dec_frame.cc:315-341 + dec_modular.cc)."""
    fd = state.fd
    vardct_dc, modular_dc, ac_metadata = _modular_stream_ids(fd)
    gx = dc_group_id % fd.xsize_dc_groups
    gy = dc_group_id // fd.xsize_dc_groups
    x0, y0, rw, rh = fd.dc_group_rect(dc_group_id)
    # --- VarDCTDC stream (dec_modular.cc:404-435)
    if not (state.fh.flags & FLAG_USE_DC_FRAME):
        extra_precision = r.read_bits(2)
        mul = 1.0 / (1 << extra_precision)
        img = ModularImage(rw, rh, 8, 3)
        modular_decode(r, img, vardct_dc(dc_group_id), ModularOptions(),
                       global_tree=state.tree, global_code=state.code,
                       global_ctx_map=state.context_map, undo_transforms=True)
        # DequantDC (compressed_dc.cc:197-245), 444 path
        fac = [state.quantizer.mul_dc(c) * mul for c in range(3)]
        cfl_x, cfl_b = state.cfl_dc_factors()
        qy = img.channel[0].data.astype(np.float64)
        qx = img.channel[1].data.astype(np.float64)
        qb = img.channel[2].data.astype(np.float64)
        dc_y = qy * fac[1]
        dc_x = qx * fac[0] + cfl_x * dc_y
        dc_b = qb * fac[2] + cfl_b * dc_y
        state.dc[0, y0:y0 + rh, x0:x0 + rw] = dc_x
        state.dc[1, y0:y0 + rh, x0:x0 + rw] = dc_y
        state.dc[2, y0:y0 + rh, x0:x0 + rw] = dc_b
    # --- ModularDC stream: channels with shift >= 3 (none in VarDCT mode
    # without extra squeezed channels); empty -> zero bits.
    # --- ACMetadata stream (dec_modular.cc:437-532)
    upper_bound = rw * rh
    nbits = (upper_bound - 1).bit_length() if upper_bound > 1 else 0
    count = r.read_bits(nbits) + 1
    cr_w = -(-rw // 8)
    cr_h = -(-rh // 8)
    img = ModularImage(rw, rh, 8, 0)
    img.channel = [
        Channel(cr_w, cr_h, 3, 3),
        Channel(cr_w, cr_h, 3, 3),
        Channel(count, 2, 0, 0),
        Channel(rw, rh, 0, 0),
    ]
    modular_decode(r, img, ac_metadata(dc_group_id), ModularOptions(),
                   global_tree=state.tree, global_code=state.code,
                   global_ctx_map=state.context_map, undo_transforms=True)
    tx0 = x0 // COLOR_TILE_DIM_IN_BLOCKS
    ty0 = y0 // COLOR_TILE_DIM_IN_BLOCKS
    state.ytox_map[ty0:ty0 + cr_h, tx0:tx0 + cr_w] = img.channel[0].data
    state.ytob_map[ty0:ty0 + cr_h, tx0:tx0 + cr_w] = img.channel[1].data
    acs_row = img.channel[2].data[0]
    qf_row = img.channel[2].data[1]
    sharp = img.channel[3].data
    from ..native_ext import get_lib, place_ac_metadata_native

    lib = get_lib()
    if lib is not None:
        ok = place_ac_metadata_native(
            lib, acs_row, qf_row, count, sharp, x0, y0, rw, rh,
            fd.xsize_blocks, fd.ysize_blocks, fd.group_dim // 8,
            QUANT_MAX, state.strategy,
            state.is_origin, state.raw_quant_field, state.epf_sharpness)
        if ok != count:
            raise JXLError("corrupted AC metadata stream")
        return
    num = 0
    for iy in range(rh):
        for ix in range(rw):
            x, y = x0 + ix, y0 + iy
            s = int(sharp[iy, ix])
            if not (0 <= s < 8):
                raise JXLError("corrupted sharpness field")
            state.epf_sharpness[y, x] = s
            if state.strategy[y, x] >= 0:
                continue
            if num >= count:
                raise JXLError("corrupted AC metadata stream")
            raw = int(acs_row[num])
            if not (0 <= raw < acs.NUM_STRATEGIES):
                raise JXLError("invalid AC strategy")
            cx_, cy_ = acs.COVERED_X[raw], acs.COVERED_Y[raw]
            if x + cx_ > fd.xsize_blocks or y + cy_ > fd.ysize_blocks:
                raise JXLError("AC strategy overflows image")
            gdim = fd.group_dim // 8
            if x % gdim + cx_ > gdim or y % gdim + cy_ > gdim:
                # transforms may not cross AC-group boundaries
                # (dec_modular.cc:515 "Invalid AC strategy")
                raise JXLError("AC strategy overflows group")
            state.strategy[y:y + cy_, x:x + cx_] = raw
            state.is_origin[y, x] = True
            qf = 1 + max(0, min(QUANT_MAX - 1, int(qf_row[num])))
            state.raw_quant_field[y:y + cy_, x:x + cx_] = qf
            num += 1
    if num != count:
        raise JXLError("AC metadata count mismatch")


def tokenize_dc_group(state: VarDCTState, dc_group_id: int, dec_tree,
                      wp_header):
    """Encoder: returns (vardct_dc_tokens, ac_metadata_tokens, count,
    extra_bits_list). Quantizes DC in place into state.quant_dc_img and
    updates state.dc to the dequantized values (for exact LLF match).
    With kUseDcFrame the DC comes from the roundtripped DC frame and no
    VarDCTDC stream exists."""
    fd = state.fd
    vardct_dc, modular_dc, ac_metadata = _modular_stream_ids(fd)
    x0, y0, rw, rh = fd.dc_group_rect(dc_group_id)
    dc_tokens = []
    if not (state.fh.flags & FLAG_USE_DC_FRAME):
        fac = [state.quantizer.mul_dc(c) for c in range(3)]
        cfl_x, cfl_b = state.cfl_dc_factors()
        dc_x = state.dc[0, y0:y0 + rh, x0:x0 + rw]
        dc_y = state.dc[1, y0:y0 + rh, x0:x0 + rw]
        dc_b = state.dc[2, y0:y0 + rh, x0:x0 + rw]
        qy = np.round(dc_y / fac[1]).astype(np.int64)
        dy = qy * fac[1]
        qx = np.round((dc_x - cfl_x * dy) / fac[0]).astype(np.int64)
        qb = np.round((dc_b - cfl_b * dy) / fac[2]).astype(np.int64)
        # overwrite with dequantized DC so LLF matches the decoder
        state.dc[0, y0:y0 + rh, x0:x0 + rw] = qx * fac[0] + cfl_x * dy
        state.dc[1, y0:y0 + rh, x0:x0 + rw] = dy
        state.dc[2, y0:y0 + rh, x0:x0 + rw] = qb * fac[2] + cfl_b * dy
        img = ModularImage(rw, rh, 8, 0)
        img.channel = [Channel(rw, rh, data=a.astype(np.int32))
                       for a in (qy, qx, qb)]
        for i in range(3):
            _tokenize_channel(img, i, vardct_dc(dc_group_id), dec_tree,
                              wp_header, dc_tokens)
    # AC metadata
    blocks = []
    for iy in range(rh):
        for ix in range(rw):
            if state.is_origin[y0 + iy, x0 + ix]:
                blocks.append((int(state.strategy[y0 + iy, x0 + ix]),
                               int(state.raw_quant_field[y0 + iy, x0 + ix])))
    count = len(blocks)
    cr_w = -(-rw // 8)
    cr_h = -(-rh // 8)
    tx0 = x0 // COLOR_TILE_DIM_IN_BLOCKS
    ty0 = y0 // COLOR_TILE_DIM_IN_BLOCKS
    meta = ModularImage(rw, rh, 8, 0)
    meta.channel = [
        Channel(cr_w, cr_h, 3, 3,
                state.ytox_map[ty0:ty0 + cr_h, tx0:tx0 + cr_w].copy()),
        Channel(cr_w, cr_h, 3, 3,
                state.ytob_map[ty0:ty0 + cr_h, tx0:tx0 + cr_w].copy()),
        Channel(count, 2, 0, 0, np.array(
            [[b[0] for b in blocks], [b[1] - 1 for b in blocks]],
            dtype=np.int32)),
        Channel(rw, rh, 0, 0,
                state.epf_sharpness[y0:y0 + rh, x0:x0 + rw].copy()),
    ]
    meta_tokens = []
    for i in range(4):
        _tokenize_channel(meta, i, ac_metadata(dc_group_id), dec_tree,
                          wp_header, meta_tokens)
    return dc_tokens, meta_tokens, count


# ------------------------------------------------------------ frame orchestr.
@functools.lru_cache(maxsize=64)
def _deadzone_thresholds(cy: int, cx: int, c: int) -> np.ndarray:
    """Per-position quantization dead-zone thresholds in quantized-value
    space (QuantizeBlockAC, enc_group.cc:46-91): values below the
    threshold are zeroed instead of rounded — the modern realization of
    the encoder's "error diffusion" stage. Quadrant layout over the wide
    coefficient array; defaults are the fast-tier constants
    (QuantizeRoundtripYBlockAC, enc_group.cc:321-353)."""
    wr, wc = min(cy, cx) * 8, max(cy, cx) * 8
    ys_b, xs_b = min(cy, cx), max(cy, cx)  # CoefficientLayout
    if c == 1:
        t = np.array([0.56, 0.62, 0.62, 0.62])
    else:
        t = np.array([0.58, 0.64, 0.64, 0.64])
        if cx * cy >= 4:
            t = np.maximum(t - 0.00744 * ys_b * xs_b, 0.5)
    yy, xx = np.mgrid[0:wr, 0:wc]
    quad = (yy >= wr // 2).astype(int) * 2 + (xx >= wc // 2).astype(int)
    return t[quad]


def quantize_deadzone(val: np.ndarray, cy: int, cx: int,
                      c: int) -> np.ndarray:
    """Threshold-quantize pre-round values in wide layout (..., wr, wc)."""
    thr = _deadzone_thresholds(cy, cx, c)
    r = np.round(val)
    return np.where(np.abs(val) < thr, 0.0, r)


def decode_dc_global(r: BitReader, state: VarDCTState) -> None:
    """Standalone DC-global section decode for the suspendable decoder
    (api.decoder); the whole-frame path uses the closure variant that
    also wires image features and modular extra channels."""
    from ..api.frame import ModularFrameState, decode_global_info

    state.matrices.decode_dc(r)
    state.quantizer.decode(r)
    state.block_ctx_map = decode_block_ctx_map(r)
    decode_cmap_dc(r, state)
    mstate = ModularFrameState()
    decode_global_info(r, state.fh, state.fd, mstate)
    state.tree = mstate.tree
    state.code = mstate.code
    state.context_map = mstate.context_map


def decode_ac_global(r: BitReader, state: VarDCTState) -> None:
    """Standalone AC-global section decode (api.decoder companion)."""
    fh, fd = state.fh, state.fd
    if not (fh.flags & FLAG_SKIP_ADAPTIVE_DC_SMOOTHING):
        fac = [state.quantizer.mul_dc(c) for c in range(3)]
        state.dc = adaptive_dc_smoothing(state.dc, fac)
    state.matrices.decode(r, num_dc_groups=fd.num_dc_groups,
                          global_tree=state.tree,
                          global_code=state.code,
                          global_ctx_map=state.context_map)
    nbits = (fd.num_groups - 1).bit_length() if fd.num_groups > 1 else 0
    state.num_histograms = 1 + (r.read_bits(nbits) if nbits else 0)
    from .coeff_order import decode_coeff_orders

    for _ in range(fh.passes.num_passes):
        used_orders = u32_read(ORDER_ENC, r)
        state.orders.append(decode_coeff_orders(used_orders, r))
        num_contexts = (state.num_histograms
                        * state.block_ctx_map.num_ac_contexts())
        code, cmap = decode_histograms(r, num_contexts)
        state.ac_code.append(code)
        state.ac_context_map.append(cmap)


def decode_vardct_frame(r: BitReader, fh: FrameHeader,
                        reference_frames=None, return_xyb: bool = False,
                        extra_out: list = None, reference_extra=None,
                        render_fn=None, dc_frames=None,
                        runner=None, want_qimg: bool = False,
                        num_threads: int = 0, ac_raw: bool = False):
    """Decode a VarDCT frame (header already read) -> (3, H, W) XYB-decoded
    linear RGB channels list (or the final XYB image if return_xyb).

    reference_frames: up to 4 saved (3, H, W) XYB frames for patches.
    extra_out: if a list is passed, decoded extra channels (modular-coded
    sub-streams, dec_modular.cc:301-410) are appended as int32 (H, W)."""
    from ..api.frame import decode_frame_sections, get_downsampling_bracket
    from ..api.frame import decode_global_info, decode_modular_group
    from ..api.frame import finalize_modular_frame
    from ..api.frame import ModularFrameState, modular_ac_stream_id
    from ..api.frame import modular_dc_stream_id

    with span("jxl.frame.init"):
        fd = fh.frame_dimensions()
        state = VarDCTState(fh, fd)
        state.want_qimg = want_qimg
        state.num_threads = num_threads
        mstate = ModularFrameState()
        subsampled = False
        from ..io.frame_header import CT_YCBCR as _CT_YCBCR_D

        if fh.color_transform == _CT_YCBCR_D \
                and not fh.chroma_subsampling.is_444():
            from .subsampled import channel_block_grid, _shifts

            subsampled = True
            hs_, vs_ = _shifts(fh)
            grids = channel_block_grid(fd, hs_, vs_)
            state.dc_sub = [np.zeros(g, dtype=np.float64) for g in grids]
            state.qblocks_sub = [dict() for _ in range(3)]
        if fh.flags & FLAG_USE_DC_FRAME:
            # the consuming frame at dc_level L reads the 1:8 frame stored
            # at level L+1 (frame_header.h:348 pyramid indexing)
            slot = fh.dc_level + 1
            if not dc_frames or slot >= len(dc_frames) \
                    or dc_frames[slot] is None:
                raise JXLError("kUseDcFrame set but no DC frame decoded")
            dcf = np.asarray(dc_frames[slot], dtype=np.float64)
            if dcf.shape[1] < fd.ysize_blocks \
                    or dcf.shape[2] < fd.xsize_blocks:
                raise JXLError("DC frame smaller than the frame's block "
                               "grid")
            state.dc[:, :fd.ysize_blocks, :fd.xsize_blocks] = \
                dcf[:, :fd.ysize_blocks, :fd.xsize_blocks]

    def dc_global(sr):
        # image features, in reference order: patches, splines, noise
        # (dec_frame.cc:269-292)
        if fh.flags & FLAG_PATCHES:
            from ..render.patches import decode_patches

            state.patches = decode_patches(
                sr, fd.xsize_padded, fd.ysize_padded,
                len(fh.nonserialized_metadata.m.extra_channel_info),
                reference_frames)
        if fh.flags & FLAG_SPLINES:
            from ..render.splines import decode_splines

            state.splines = decode_splines(sr, fd.xsize * fd.ysize)
        if fh.flags & FLAG_NOISE:
            from ..render.noise import decode_noise

            state.noise_lut = decode_noise(sr)
        state.matrices.decode_dc(sr)
        state.quantizer.decode(sr)
        state.block_ctx_map = decode_block_ctx_map(sr)
        decode_cmap_dc(sr, state)
        decode_global_info(sr, fh, fd, mstate)
        state.tree = mstate.tree
        state.code = mstate.code
        state.context_map = mstate.context_map

    def dc_group(g, sr):
        if subsampled:
            from .subsampled import decode_dc_group_sub

            decode_dc_group_sub(sr, state, g)
        else:
            decode_dc_group(sr, state, g)
        # ModularDC group (squeezed >=3 channels) for extra channels
        gx = g % fd.xsize_dc_groups
        gy = g // fd.xsize_dc_groups
        rect = (gx * fd.dc_group_dim, gy * fd.dc_group_dim,
                fd.dc_group_dim, fd.dc_group_dim)
        decode_modular_group(sr, fh, fd, mstate, rect, 3, 1000,
                             modular_dc_stream_id(fd, g))

    def ac_global(sr):
        if not (fh.flags & FLAG_SKIP_ADAPTIVE_DC_SMOOTHING):
            fac = [state.quantizer.mul_dc(c) for c in range(3)]
            state.dc = adaptive_dc_smoothing(state.dc, fac)
        state.matrices.decode(sr, num_dc_groups=fd.num_dc_groups,
                              global_tree=state.tree,
                              global_code=state.code,
                              global_ctx_map=state.context_map)
        nbits = (fd.num_groups - 1).bit_length() if fd.num_groups > 1 else 0
        state.num_histograms = 1 + (sr.read_bits(nbits) if nbits else 0)
        for _ in range(fh.passes.num_passes):
            used_orders = u32_read(ORDER_ENC, sr)
            from .coeff_order import decode_coeff_orders

            state.orders.append(decode_coeff_orders(used_orders, sr))
            num_contexts = (state.num_histograms
                            * state.block_ctx_map.num_ac_contexts())
            code, cmap = decode_histograms(sr, num_contexts)
            state.ac_code.append(code)
            state.ac_context_map.append(cmap)

    def ac_group(g, p, sr):
        if subsampled:
            from .subsampled import decode_ac_group_sub

            decode_ac_group_sub(sr, state, g, p)
        else:
            decode_ac_group(sr, state, g, p)
        # extra channels ride per-group modular AC streams
        # (dec_frame.cc:478-540 ProcessACGroup modular part)
        gx = g % fd.xsize_groups
        gy = g // fd.xsize_groups
        rect = (gx * fd.group_dim, gy * fd.group_dim, fd.group_dim,
                fd.group_dim)
        min_shift, max_shift = get_downsampling_bracket(fh.passes, p)
        decode_modular_group(sr, fh, fd, mstate, rect, min_shift, max_shift,
                             modular_ac_stream_id(fd, g, p))

    ac_bulk = None
    if (ac_raw and not subsampled
            and fh.nonserialized_metadata.m.num_extra_channels == 0):
        # TPU entropy-decode path (ops/ans_tpu.py): capture the raw AC
        # section byte ranges; the caller runs the device kernel. The
        # caller MUST fall back to a full host decode if the kernel
        # rejects the stream shape.
        def ac_bulk(data, per_pass):
            state.ac_raw = (data, per_pass)
            return True
    elif (not subsampled
            and fh.nonserialized_metadata.m.num_extra_channels == 0
            and (getattr(state, "want_qimg", False) or render_fn is None)):
        def ac_bulk(data, per_pass):
            return decode_ac_bulk_native(state, data, per_pass)

    decode_frame_sections(r, fh, dc_global, dc_group, ac_global, ac_group,
                          runner=runner, decode_ac_bulk=ac_bulk)
    extra_planes = None
    if mstate.full_image is not None and mstate.full_image.channel:
        img = finalize_modular_frame(fh, mstate)
        extra_planes = []
        for k, ch in enumerate(img.channel):
            ecups = fh.extra_channel_upsampling[k] \
                if fh.extra_channel_upsampling else 1
            if ecups > 1:
                # EC upsample stage (stage_upsampling.cc runs for extra
                # channels too): same 5x5 signaled kernels
                from ..render.upsample import (kernels_from_metadata,
                                               upsample)

                kern = kernels_from_metadata(fh.nonserialized_metadata,
                                             ecups)
                up = upsample(ch.data.astype(np.float64), ecups,
                              kernels=kern)
                extra_planes.append(
                    up[:fd.ysize_upsampled, :fd.xsize_upsampled])
            else:
                extra_planes.append(ch.data[:fd.ysize, :fd.xsize])
    if render_fn is not None:
        # device render path: must fill state.xyb from state.qblocks
        render_fn(state)
        if getattr(state, "device_output_done", False):
            # final pixels were produced on device (decode_tpu fast path)
            return None
    elif subsampled:
        from .subsampled import render_groups_sub

        render_groups_sub(state)
    else:
        render_groups(state)
    # render: XYB -> linear RGB (gaborish/EPF handled by render pipeline
    # when enabled; round-1 encoder disables them)
    if (fh.loop_filter.gab or fh.loop_filter.epf_iters > 0) \
            and not getattr(state, "restoration_done", False):
        from ..render.pipeline import apply_restoration

        state.xyb = apply_restoration(state.xyb, fh, state)
    if state.patches is not None:
        from ..render.patches import apply_patches, uses_alpha

        m = fh.nonserialized_metadata.m
        touches_extra = any(
            uses_alpha(info.mode)
            or (i > 0 and info.mode != 0)
            for blend in state.patches.blendings
            for i, info in enumerate(blend))
        norm_extras = None
        maxvals = []
        if extra_planes is not None and touches_extra:
            maxvals = [
                (1 << (m.extra_channel_info[k].bit_depth.bits_per_sample
                       if k < len(m.extra_channel_info) else 8)) - 1
                for k in range(len(extra_planes))]
            norm_extras = [p.astype(np.float64) / mv
                           for p, mv in zip(extra_planes, maxvals)]
        premul = bool(m.extra_channel_info
                      and getattr(m.extra_channel_info[0],
                                  "alpha_associated", False))
        apply_patches(state.xyb, state.patches, reference_frames, add=True,
                      extra=norm_extras, ref_extra=reference_extra,
                      alpha_is_premultiplied=premul)
        if norm_extras is not None:
            extra_planes = [p * mv
                            for p, mv in zip(norm_extras, maxvals)]
    if state.splines is not None:
        from ..render.splines import compute_segments, draw_segments

        segs = compute_segments(state.splines, fd.xsize_padded,
                                fd.ysize_padded,
                                y_to_x=state.ytox(0), y_to_b=state.ytob(0))
        draw_segments(state.xyb, segs, add=True)
    if state.noise_lut is not None:
        from ..render.noise import add_noise, random_3planes

        # per-AC-group noise fields (PrepareNoiseInput seeds by group origin)
        planes = [np.zeros((fd.ysize_padded, fd.xsize_padded),
                           dtype=np.float32) for _ in range(3)]
        for g in range(fd.num_groups):
            gx0, gy0, gw, gh = fd.group_rect(g)
            ps = random_3planes(1, 0, gx0, gy0, gw, gh)
            for c in range(3):
                planes[c][gy0:gy0 + gh, gx0:gx0 + gw] = ps[c]
        state.xyb = add_noise(state.xyb, planes, state.noise_lut,
                              state.ytox(state.ytox_dc),
                              state.ytob(state.ytob_dc))
    from ..ops.xyb import xyb_to_linear_rgb

    if extra_out is not None and extra_planes is not None:
        extra_out.extend(extra_planes)
    xyb = state.xyb[:, :fd.ysize, :fd.xsize]
    if fh.upsampling > 1:
        from ..render.upsample import kernels_from_metadata, upsample

        kern = kernels_from_metadata(fh.nonserialized_metadata,
                                     fh.upsampling)
        xyb = np.stack([upsample(xyb[c], fh.upsampling, kernels=kern)
                        for c in range(3)])
        xyb = xyb[:, :fd.ysize_upsampled, :fd.xsize_upsampled]
    if return_xyb:
        # save_before_color_transform path: fully rendered XYB (dec_cache.cc
        # WriteToImageBundleStage sits after all feature stages)
        return xyb
    from ..io.frame_header import CT_NONE, CT_YCBCR

    if fh.color_transform == CT_YCBCR:
        rgb = ycbcr_to_rgb(xyb)
    elif fh.color_transform == CT_NONE:
        rgb = xyb  # channels are already (R, G, B)
    else:
        rgb = xyb_to_linear_rgb(xyb)
    return [rgb[c] for c in range(3)]


def ycbcr_to_rgb(planes: np.ndarray) -> np.ndarray:
    """Full-range BT.601 (stage_ycbcr.cc:31-52): planes (Cb, Y, Cr) in
    [-0.5, 0.5]-ish units -> RGB in [0, 1]."""
    cb, y, cr = planes[0], planes[1], planes[2]
    yp = y + 128.0 / 255
    r = yp + 1.402 * cr
    g = yp + (-0.114 * 1.772 / 0.587) * cb + (-0.299 * 1.402 / 0.587) * cr
    b = yp + 1.772 * cb
    return np.stack([r, g, b])


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """Inverse of ycbcr_to_rgb: RGB [0,1] -> (Cb, Y, Cr) planes."""
    r, g, b = rgb[0], rgb[1], rgb[2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) / 1.772
    cr = (r - y) / 1.402
    return np.stack([cb, y - 128.0 / 255, cr])


def shift_right_round0(v: np.ndarray, shift: int) -> np.ndarray:
    """Arithmetic shift truncating toward zero (enc_progressive_split.cc:24-28)."""
    neg = v < 0
    add = np.where(neg, (1 << shift) - 1, 0)
    return (v + add) >> shift


def split_progressive(qall: np.ndarray, shifts) -> list:
    """SplitACCoefficients, shift-only progressive
    (enc_progressive_split.cc:20-70): per pass p, code
    trunc(remaining / 2^shift_p); decoder accumulates v_p << shift_p."""
    outputs = []
    prev_shift = 0
    v = qall
    for i, shift in enumerate(shifts):
        if i > 0 and prev_shift != 0:
            v = v - (shift_right_round0(v, prev_shift) << prev_shift)
        outputs.append(shift_right_round0(v, shift))
        prev_shift = shift
    return outputs


def _est_token_bits(q: np.ndarray, cb: int) -> float:
    """Rough cost of coding quantized AC coefficients (EstimateEntropy
    spirit, enc_ac_strategy.cc:361): ~2 bits per nonzero + magnitude bits +
    nzeros overhead."""
    a = np.abs(q[..., cb:])
    nz = a > 0
    bits = float(nz.sum()) * 2.0 + float(np.log2(1.0 + a[nz]).sum())
    return bits + 8.0  # per-channel nzeros token overhead


_INFO_LOSS_MUL = 320.0  # tuned: RD-dominates DCT8-only on noisy
# content while leaving smooth-content merges untouched (see commit)


def _tile_cost_device(state, xyb, rows, cols, kind, tby, tbx, device):
    """_batched_tile_cost on `device`: the "tile_cost" program
    (_tile_cost_program) at the JAX package's static key (rows, cols, tby,
    tbx). The opsin image is uploaded once per ACS search (cached on the
    state) and enters as an input; the kind enters as its matrices, the
    per-tile field and the global scale as data, as in the JAX program."""
    from ..ops import programs
    from ..ops.staging import to_device

    cache = getattr(state, "_xyb_dev", None)
    if cache is None or cache[0] is not xyb or cache[1].device != device:
        cache = (xyb, to_device(np.asarray(xyb, dtype=np.float32), device))
        state._xyb_dev = cache
    cy, cx = rows // 8, cols // 8
    qf = state.raw_quant_field[:tby * cy, :tbx * cx].reshape(
        tby, cy, tbx, cx).mean(axis=(1, 3)).astype(np.float32)
    dm_inv, dm = (np.stack([get(kind, c) for c in range(3)]).astype(
        np.float32) for get in (state.matrices.inv_matrix,
                                state.matrices.dequant_matrix))
    out = programs.run(
        "tile_cost", (rows, cols, tby, tbx), _tile_cost_program, cache[1],
        qf, dm_inv, dm, np.asarray(state.quantizer.inv_global_scale,
                                   dtype=np.float32),
        rows=rows, cols=cols, tby=tby, tbx=tbx, device=device,
        readback=True)
    return out.astype(np.float64)


def _tile_cost_program(x, qf, dm_inv, dm, igs, rows, cols, tby, tbx):
    """The JAX package's _TILE_COST_JIT in torch: forward DCT of every
    candidate rows x cols tile of the opsin image x f32[3, H, W], quantize
    with the per-tile field qf f32[tby, tbx] and the kind's matrices
    dm_inv, dm f32[3, min, max] at the global scale igs (0-d), entropy
    bits + 8-norm info loss, in the JAX package's f32 forms; the DCT
    matrices and channel weights are per-device constants."""
    import torch

    from ..ops import programs
    from ..ops.dct import fwd_matrix, inv_matrix
    from ..ops.pipeline import _powf

    dev = x.device
    fr, fc, ir, ic = (programs.constant(
        f"{name}{n}", dev, lambda f=f, n=n: f(n).astype(np.float32))
        for name, f, n in (("dct_fwd", fwd_matrix, rows),
                           ("dct_fwd", fwd_matrix, cols),
                           ("dct_inv", inv_matrix, rows),
                           ("dct_inv", inv_matrix, cols)))
    chan_mul = programs.constant(
        "tile_chan_mul", dev,
        lambda: (np.array([10.2, 1.0, 1.03]) ** 8).astype(np.float32))
    dm_inv, dm = dm_inv[:, None, None], dm[:, None, None]
    crop = x[:, :tby * rows, :tbx * cols]
    tiles = crop.reshape(3, tby, rows, tbx, cols).permute(0, 1, 3, 2, 4)
    co = torch.einsum("ur,ctmrk,vk->ctmuv", fr, tiles, fc)
    if rows >= cols:
        co = co.transpose(-2, -1)
    scaled = (igs / qf)[None, :, :, None, None]
    val = co * dm_inv / scaled
    qs = torch.round(val)
    q = torch.abs(qs)
    nz = q > 0
    bits = nz.sum(dim=(3, 4)) * 2.0 \
        + torch.where(nz, torch.log2(1.0 + q), 0.0).sum(dim=(3, 4))
    err = torch.where(dm_inv > 0, (qs - val) * dm * scaled, 0.0)
    if rows >= cols:
        err = err.transpose(-2, -1)
    pix = torch.einsum("ru,ctmuv,kv->ctmrk", ir, err, ic)
    a2 = pix * pix
    a4 = a2 * a2
    loss8 = (a4 * a4).sum(dim=(3, 4)) * chan_mul[:, None, None]
    size = rows * cols
    loss_scalar = _powf(loss8.sum(dim=0) / size, 0.125) * size \
        / (igs / qf)
    return bits.sum(dim=0) + _INFO_LOSS_MUL * loss_scalar + 24.0


def _batched_tile_cost(state: VarDCTState, xyb: np.ndarray, rows: int,
                       cols: int, kind: int, device=None) -> np.ndarray:
    """Estimated coding cost of covering the image with rows x cols px
    transforms: -> f64[nby//(rows//8), nbx//(cols//8)] (edge-partial tiles
    excluded). Vectorized EstimateEntropy analog (enc_ac_strategy.cc:361):
    2 bits per nonzero + magnitude bits + per-channel nzeros overhead.
    device: a torch device runs _tile_cost_device there; None, host
    numpy."""
    from ..ops.dct import fwd_matrix

    fd = state.fd
    nby, nbx = fd.ysize_blocks, fd.xsize_blocks
    cy, cx = rows // 8, cols // 8
    tby, tbx = nby // cy, nbx // cx
    if tby == 0 or tbx == 0:
        return np.full((tby, tbx), np.inf)
    if device is not None:
        return _tile_cost_device(state, xyb, rows, cols, kind, tby, tbx,
                                 device)
    crop = xyb[:, :tby * rows, :tbx * cols].astype(np.float32)
    tiles = crop.reshape(3, tby, rows, tbx, cols).transpose(0, 1, 3, 2, 4)
    co = np.einsum("ur,ctmrk,vk->ctmuv",
                   fwd_matrix(rows).astype(np.float32), tiles,
                   fwd_matrix(cols).astype(np.float32), optimize=True)
    if rows >= cols:  # wide layout, transposed for tall/square
        co = np.swapaxes(co, -2, -1)
    dm_inv = np.stack([state.matrices.inv_matrix(kind, c)
                       for c in range(3)]).astype(np.float32)
    # (3, min, max), LLF zeroed
    qf = state.raw_quant_field[:tby * cy, :tbx * cx].reshape(
        tby, cy, tbx, cx).mean(axis=(1, 3))
    scaled = (state.quantizer.inv_global_scale
              / qf)[None, :, :, None, None].astype(np.float32)
    qs = np.round(co * dm_inv[:, None, None] / scaled)
    q = np.abs(qs)
    nz = q > 0
    bits = (nz.sum(axis=(3, 4)) * 2.0
            + np.log2(1.0 + q, where=nz, out=np.zeros_like(q)).sum(
                axis=(3, 4)))
    # quantization info loss: 8-norm of the PIXEL-domain reconstruction
    # error (EstimateEntropy, enc_ac_strategy.cc:470-495). The 8th power
    # prices concentrated spatial error — the ringing a large transform
    # creates around detail — which a coefficient-domain L1 cannot see
    # (any orthonormal basis gives the same L2 budget).
    from ..ops.dct import idct2d

    dm = np.stack([state.matrices.dequant_matrix(kind, c)
                   for c in range(3)]).astype(np.float32)
    coded = dm_inv > 0  # LLF positions are coded via DC, skip them
    err = np.where(coded[:, None, None],
                   (qs - co * dm_inv[:, None, None] / scaled)
                   * dm[:, None, None] * scaled, 0.0)
    pix_err = idct2d(err, rows, cols)
    chan_mul = np.array([10.2, 1.0, 1.03]) ** 8
    loss8 = (np.abs(pix_err) ** 8).sum(axis=(3, 4)) \
        * chan_mul[:, None, None]
    size = rows * cols
    loss_scalar = (loss8.sum(axis=0) / size) ** 0.125 * size \
        / scaled[0, :, :, 0, 0]
    loss_bits = _INFO_LOSS_MUL * loss_scalar
    return bits.sum(axis=0) + loss_bits + 24.0  # + 3x nzeros overhead


def _adjust_quant_field(state: VarDCTState, distance: float) -> None:
    """AdjustQuantField (enc_adaptive_quantization.cc:1199-1246): each
    merged transform's field becomes the max of its covered blocks'
    values, mixed toward the mean at high distances."""
    mixer = 1.0
    if distance > 1.54138:
        mixer = max(0.0, 1.0 - (distance - 1.54138) * 0.56391)
    qf = state.raw_quant_field
    for (by, bx) in zip(*np.nonzero(state.is_origin)):
        s = int(state.strategy[by, bx])
        cy_, cx_ = acs.COVERED_Y[s], acs.COVERED_X[s]
        if cy_ == 1 and cx_ == 1:
            continue
        block = qf[by:by + cy_, bx:bx + cx_]
        v = float(block.max())
        if cy_ * cx_ >= 4:
            v = v * mixer + (1.0 - mixer) * float(block.mean())
        qf[by:by + cy_, bx:bx + cx_] = max(1, int(round(v)))


def _choose_ac_strategies(state: VarDCTState, xyb: np.ndarray,
                          max_px: int = 256, effort: int = None,
                          bt_target: float = None, device=None) -> None:
    """Merge-family AC strategy search: per 32x32 supertile choose among
    DCT8 / DCT16X8 / DCT8X16 / DCT16X16 / DCT32X32 by estimated token
    cost (FindBest8x8Transform + TryMergeAcs +
    FindBestFirstLevelDivisionForSquare, enc_ac_strategy.cc:496-810,
    batched over the whole grid instead of sequential merging).

    max_px caps the merge ladder (effort tiers, doc/encode_effort.md:
    e4 "simple variable blocks" stops at 16, e5 at 32, e6+ runs the
    full ladder). device: where the tile costs run (_batched_tile_cost).
    """
    fd = state.fd
    nby, nbx = fd.ysize_blocks, fd.xsize_blocks
    c8 = _batched_tile_cost(state, xyb, 8, 8, acs.QUANT_TABLE[acs.DCT], device)
    c16 = _batched_tile_cost(state, xyb, 16, 16,
                             acs.QUANT_TABLE[acs.DCT16X16], device)
    c16x8 = _batched_tile_cost(state, xyb, 16, 8,
                               acs.QUANT_TABLE[acs.DCT16X8], device)
    c8x16 = _batched_tile_cost(state, xyb, 8, 16,
                               acs.QUANT_TABLE[acs.DCT8X16], device)
    want32 = max_px >= 32
    c32 = c32x16 = c16x32 = None
    if want32:
        c32 = _batched_tile_cost(state, xyb, 32, 32,
                                 acs.QUANT_TABLE[acs.DCT32X32], device)
        c32x16 = _batched_tile_cost(state, xyb, 32, 16,
                                    acs.QUANT_TABLE[acs.DCT32X16], device)
        c16x32 = _batched_tile_cost(state, xyb, 16, 32,
                                    acs.QUANT_TABLE[acs.DCT16X32], device)
    MUL16 = 0.98    # slight bias toward merging (mirrors round-1 0.98)
    MUL_HALF = 0.985
    MUL32 = 0.94
    MUL_HALF32 = 0.97

    def place(by, bx, strategy):
        cy_, cx_ = acs.COVERED_Y[strategy], acs.COVERED_X[strategy]
        state.strategy[by:by + cy_, bx:bx + cx_] = strategy
        state.is_origin[by:by + cy_, bx:bx + cx_] = False
        state.is_origin[by, bx] = True

    def best_quadrant(by, bx):
        """-> (cost, placement list) for the 2x2-block quadrant at
        (by, bx)."""
        opts = [(float(c8[by:by + 2, bx:bx + 2].sum()),
                 [(by, bx, acs.DCT), (by, bx + 1, acs.DCT),
                  (by + 1, bx, acs.DCT), (by + 1, bx + 1, acs.DCT)])]
        if by % 2 == 0 and bx % 2 == 0:
            opts.append((float(c16[by // 2, bx // 2]) * MUL16,
                         [(by, bx, acs.DCT16X16)]))
            opts.append(((float(c16x8[by // 2, bx])
                          + float(c16x8[by // 2, bx + 1])) * MUL_HALF,
                         [(by, bx, acs.DCT16X8),
                          (by, bx + 1, acs.DCT16X8)]))
            opts.append(((float(c8x16[by, bx // 2])
                          + float(c8x16[by + 1, bx // 2])) * MUL_HALF,
                         [(by, bx, acs.DCT8X16),
                          (by + 1, bx, acs.DCT8X16)]))
        return min(opts, key=lambda o: o[0])

    # upward merge ladder past 32x32 (TryMergeAcs reaches 256x256,
    # enc_ac_strategy.cc:601; 64-level merges capture the bulk of the
    # win on smooth content)
    big = min(nby, nbx) >= 8 and max_px >= 64
    c64 = c64x32 = c32x64 = None
    if big:
        c64 = _batched_tile_cost(state, xyb, 64, 64,
                                 acs.QUANT_TABLE[acs.DCT64X64], device)
        c64x32 = _batched_tile_cost(state, xyb, 64, 32,
                                    acs.QUANT_TABLE[acs.DCT64X32], device)
        c32x64 = _batched_tile_cost(state, xyb, 32, 64,
                                    acs.QUANT_TABLE[acs.DCT32X64], device)
    MUL64 = 1.0     # measured: unbiased 64-level costs pick
    MUL_HALF64 = 1.0  # correctly on both smooth and textured corpora

    def best_32(by0, bx0):
        """-> (cost, placements) for the 4x4-block supertile: 2x2 quadrant
        compositions vs the square vs both half-splits
        (FindBestFirstLevelDivisionForSquare, blocks=4)."""
        quads = [best_quadrant(by0 + dy, bx0 + dx)
                 for dy in (0, 2) for dx in (0, 2)]
        opts = [(sum(q[0] for q in quads),
                 [p for _, pl in quads for p in pl])]
        opts.append((float(c32[by0 // 4, bx0 // 4]) * MUL32,
                     [(by0, bx0, acs.DCT32X32)]))
        opts.append(((float(c32x16[by0 // 4, bx0 // 2])
                      + float(c32x16[by0 // 4, bx0 // 2 + 1])) * MUL_HALF32,
                     [(by0, bx0, acs.DCT32X16),
                      (by0, bx0 + 2, acs.DCT32X16)]))
        opts.append(((float(c16x32[by0 // 2, bx0 // 4])
                      + float(c16x32[by0 // 2 + 1, bx0 // 4])) * MUL_HALF32,
                     [(by0, bx0, acs.DCT16X32),
                      (by0 + 2, bx0, acs.DCT16X32)]))
        return min(opts, key=lambda o: o[0])

    def best_64(by0, bx0):
        subs = [best_32(by0 + dy, bx0 + dx)
                for dy in (0, 4) for dx in (0, 4)]
        cost = sum(s[0] for s in subs)
        place64 = [p for _, pl in subs for p in pl]
        opts = [(cost, place64)]
        sy, sx = by0 // 8, bx0 // 8
        opts.append((float(c64[sy, sx]) * MUL64,
                     [(by0, bx0, acs.DCT64X64)]))
        opts.append(((float(c64x32[sy, bx0 // 4])
                      + float(c64x32[sy, bx0 // 4 + 1])) * MUL_HALF64,
                     [(by0, bx0, acs.DCT64X32),
                      (by0, bx0 + 4, acs.DCT64X32)]))
        opts.append(((float(c32x64[by0 // 4, sx])
                      + float(c32x64[by0 // 4 + 1, sx])) * MUL_HALF64,
                     [(by0, bx0, acs.DCT32X64),
                      (by0 + 4, bx0, acs.DCT32X64)]))
        return min(opts, key=lambda o: o[0])

    # 128/256 rungs: beyond the reference's merge heuristic (its comment
    # at enc_ac_strategy.cc:905 lists them as "not yet included"), but
    # the giant DCTs pay off on very smooth content and fewer, larger
    # transforms also batch better on the MXU
    big128 = min(nby, nbx) >= 16 and max_px >= 128
    big256 = min(nby, nbx) >= 32 and max_px >= 256
    if big and (big128 or big256):
        # giant transforms only win on very smooth regions; skip their
        # (full-image DCT) cost passes unless some 128x128 area's 64-level
        # costs are already tiny (flat gradients measure ~6k bits per
        # 64-tile here vs ~45k on photographic content)
        ty2, tx2 = (c64.shape[0] // 2) * 2, (c64.shape[1] // 2) * 2
        if ty2 and tx2:
            pooled = c64[:ty2, :tx2].reshape(ty2 // 2, 2, tx2 // 2, 2) \
                .sum(axis=(1, 3))
            want_big = bool((pooled < 60000.0).any())
        else:
            want_big = False
        big128 = big128 and want_big
        big256 = big256 and want_big
    c128 = c128x64 = c64x128 = c256 = c256x128 = c128x256 = None
    if big128:
        c128 = _batched_tile_cost(state, xyb, 128, 128,
                                  acs.QUANT_TABLE[acs.DCT128X128], device)
        c128x64 = _batched_tile_cost(state, xyb, 128, 64,
                                     acs.QUANT_TABLE[acs.DCT128X64], device)
        c64x128 = _batched_tile_cost(state, xyb, 64, 128,
                                     acs.QUANT_TABLE[acs.DCT64X128], device)
    if big256:
        c256 = _batched_tile_cost(state, xyb, 256, 256,
                                  acs.QUANT_TABLE[acs.DCT256X256], device)
        c256x128 = _batched_tile_cost(state, xyb, 256, 128,
                                      acs.QUANT_TABLE[acs.DCT256X128], device)
        c128x256 = _batched_tile_cost(state, xyb, 128, 256,
                                      acs.QUANT_TABLE[acs.DCT128X256], device)

    def best_128(by0, bx0):
        subs = [best_64(by0 + dy, bx0 + dx)
                for dy in (0, 8) for dx in (0, 8)]
        opts = [(sum(s[0] for s in subs),
                 [p for _, pl in subs for p in pl])]
        sy, sx = by0 // 16, bx0 // 16
        opts.append((float(c128[sy, sx]) * MUL64,
                     [(by0, bx0, acs.DCT128X128)]))
        opts.append(((float(c128x64[sy, bx0 // 8])
                      + float(c128x64[sy, bx0 // 8 + 1])) * MUL_HALF64,
                     [(by0, bx0, acs.DCT128X64),
                      (by0, bx0 + 8, acs.DCT128X64)]))
        opts.append(((float(c64x128[by0 // 8, sx])
                      + float(c64x128[by0 // 8 + 1, sx])) * MUL_HALF64,
                     [(by0, bx0, acs.DCT64X128),
                      (by0 + 8, bx0, acs.DCT64X128)]))
        return min(opts, key=lambda o: o[0])

    def best_256(by0, bx0):
        subs = [best_128(by0 + dy, bx0 + dx)
                for dy in (0, 16) for dx in (0, 16)]
        opts = [(sum(s[0] for s in subs),
                 [p for _, pl in subs for p in pl])]
        sy, sx = by0 // 32, bx0 // 32
        opts.append((float(c256[sy, sx]) * MUL64,
                     [(by0, bx0, acs.DCT256X256)]))
        opts.append(((float(c256x128[sy, bx0 // 16])
                      + float(c256x128[sy, bx0 // 16 + 1])) * MUL_HALF64,
                     [(by0, bx0, acs.DCT256X128),
                      (by0, bx0 + 16, acs.DCT256X128)]))
        opts.append(((float(c128x256[by0 // 16, sx])
                      + float(c128x256[by0 // 16 + 1, sx])) * MUL_HALF64,
                     [(by0, bx0, acs.DCT128X256),
                      (by0 + 16, bx0, acs.DCT128X256)]))
        return min(opts, key=lambda o: o[0])

    done = np.zeros((nby, nbx), dtype=bool)
    if big256:
        for sy in range(nby // 32):
            for sx in range(nbx // 32):
                by0, bx0 = sy * 32, sx * 32
                _, placements = best_256(by0, bx0)
                for (by, bx, s) in placements:
                    place(by, bx, s)
                done[by0:by0 + 32, bx0:bx0 + 32] = True
    if big128:
        for sy in range(nby // 16):
            for sx in range(nbx // 16):
                by0, bx0 = sy * 16, sx * 16
                if done[by0, bx0]:
                    continue
                _, placements = best_128(by0, bx0)
                for (by, bx, s) in placements:
                    place(by, bx, s)
                done[by0:by0 + 16, bx0:bx0 + 16] = True
    if big:
        for sy in range(nby // 8):
            for sx in range(nbx // 8):
                by0, bx0 = sy * 8, sx * 8
                if done[by0, bx0]:
                    continue
                _, placements = best_64(by0, bx0)
                for (by, bx, s) in placements:
                    place(by, bx, s)
                done[by0:by0 + 8, bx0:bx0 + 8] = True
    if want32:
        for sy in range(nby // 4):
            for sx in range(nbx // 4):
                by0, bx0 = sy * 4, sx * 4
                if done[by0, bx0]:
                    continue
                _, placements = best_32(by0, bx0)
                for (by, bx, s) in placements:
                    place(by, bx, s)
                done[by0:by0 + 4, bx0:bx0 + 4] = True
    # leftover 16x16 quadrants outside the 32-aligned area
    for by in range(0, (nby // 2) * 2, 2):
        for bx in range(0, (nbx // 2) * 2, 2):
            if done[by, bx]:
                continue
            cost, placements = best_quadrant(by, bx)
            for (pby, pbx, s) in placements:
                place(pby, pbx, s)
    _choose_small_transforms(state, xyb, c8, effort=effort,
                             bt_target=bt_target)


_SUB8_MATS = {}


def _sub8_matrices(strategy: int):
    """(fwd, inv) 64x64 matrices of a single-block strategy, probed from
    the linear transform_from/to_pixels maps (cached)."""
    m = _SUB8_MATS.get(strategy)
    if m is None:
        basis = np.eye(64).reshape(64, 8, 8)
        fwd = np.stack([transform_from_pixels(strategy, b).reshape(-1)
                        for b in basis], axis=1)
        inv = np.stack([transform_to_pixels(
            strategy, e.reshape(8, 8)).reshape(-1)
            for e in np.eye(64)], axis=1)
        m = (fwd.astype(np.float32), inv.astype(np.float32))
        _SUB8_MATS[strategy] = m
    return m


def _choose_small_transforms(state: VarDCTState, xyb: np.ndarray,
                             c8: np.ndarray, effort: int = None,
                             bt_target: float = None) -> None:
    """Post-pass of FindBest8x8Transform (enc_ac_strategy.cc:496-600):
    every block still coded as single DCT8 competes against the sub-8x8
    family (IDENTITY, DCT2X2, DCT4X4, DCT4X8/8X4, AFV0-3), evaluated
    with the same bits + info-loss estimator as the merge ladder but
    batched as one 64x64 matmul per candidate over all blocks. The
    per-type entropy multipliers and the quality-dependent adjustments
    mirror kTransforms8x8 (relative to DCT's 0.8 baseline)."""
    fd = state.fd
    nby, nbx = fd.ysize_blocks, fd.xsize_blocks
    inv_gs = state.quantizer.inv_global_scale
    # (strategy, entropy_mul relative to DCT, min effort): the reference
    # gates 4x8/AFV behind encoding_speed_tier<=4 (~effort>=6) and the
    # rest behind tier<=5 (~effort>=5)
    family = [(acs.DCT4X4, 1.08 / 0.8, 5), (acs.DCT2X2, 0.95 / 0.8, 5),
              (acs.IDENTITY, 1.0427542510634957 / 0.8, 5),
              (acs.DCT4X8, 0.85931637428340035 / 0.8, 6),
              (acs.DCT8X4, 0.85931637428340035 / 0.8, 6),
              (acs.AFV0, 0.81779489591359944 / 0.8, 6),
              (acs.AFV1, 0.81779489591359944 / 0.8, 6),
              (acs.AFV2, 0.81779489591359944 / 0.8, 6),
              (acs.AFV3, 0.81779489591359944 / 0.8, 6)]
    e = 7 if effort is None else effort
    candidates = [(s, m) for s, m, emin in family if e >= emin]
    if not candidates:
        return
    is_dct8 = (state.strategy[:nby, :nbx] == acs.DCT) & \
        state.is_origin[:nby, :nbx]
    sel = np.argwhere(is_dct8)
    if len(sel) == 0:
        return
    by_i, bx_i = sel[:, 0], sel[:, 1]
    tiles = xyb[:, :nby * 8, :nbx * 8].reshape(3, nby, 8, nbx, 8)
    flat = np.ascontiguousarray(
        tiles[:, by_i, :, bx_i].reshape(len(sel), 3, 64).astype(np.float32))
    scaled = (inv_gs / state.raw_quant_field[by_i, bx_i]) \
        .astype(np.float32)[:, None, None]
    bt = 1.0 if bt_target is None else float(bt_target)
    favor22 = 0.4 * ((5.0 - bt) / 5.0) ** 2 if bt < 5.0 else 0.0
    avoid = 0.0
    if bt > 4.0:
        avoid = 0.5 * ((12.0 - 4.0) / (bt - 4.0) if bt < 12.0 else 1.0)
    chan_mul = (np.array([10.2, 1.0, 1.03], np.float32) ** 8)[:, None]
    best_cost = c8[by_i, bx_i].astype(np.float32)
    best_s = np.full(len(sel), -1, dtype=np.int32)
    for s, mul in candidates:
        if s in (acs.DCT2X2, acs.IDENTITY):
            mul -= favor22
        else:
            mul += avoid
        fwd, inv = _sub8_matrices(s)
        kind = acs.QUANT_TABLE[s]
        dm_inv = np.stack([state.matrices.inv_matrix(kind, c)
                           for c in range(3)]).reshape(3, 64) \
            .astype(np.float32)
        dm = np.stack([state.matrices.dequant_matrix(kind, c)
                       for c in range(3)]).reshape(3, 64).astype(np.float32)
        coded = dm_inv[0] > 0  # LLF coded via DC, same mask all channels
        co = flat @ fwd.T                    # (N, 3, 64)
        val = co * dm_inv / scaled
        qs = np.round(val)
        q = np.abs(qs)
        nz = (q > 0) & coded
        bits = (nz.sum(axis=2) * 2.0
                + np.log2(1.0 + q, where=nz,
                          out=np.zeros_like(q)).sum(axis=2)).sum(axis=1)
        err = np.where(coded, (qs - val) * dm * scaled, 0.0)
        pix_err = err @ inv.T
        loss8 = ((np.abs(pix_err) ** 8).sum(axis=2) * chan_mul.T).sum(axis=1)
        loss = (loss8 / 64.0) ** 0.125 * 64.0 / scaled[:, 0, 0]
        cost = bits * np.float32(mul) + _INFO_LOSS_MUL * loss + 24.0
        better = cost < best_cost
        best_cost = np.where(better, cost, best_cost)
        best_s = np.where(better, s, best_s)
    chosen = best_s >= 0
    state.strategy[by_i[chosen], bx_i[chosen]] = best_s[chosen]


def encode_vardct_frame(writer: BitWriter, rgb_linear: np.ndarray,
                        fh: FrameHeader, distance: float = 1.0,
                        adaptive_quant: bool = True,
                        cfl: bool = True, noise_lut=None,
                        ac_strategy_search: bool = True,
                        custom_orders: bool = True,
                        splines=None, patches=None,
                        reference_frames=None,
                        extra_channels=None,
                        custom_quant: dict = None,
                        precomputed: dict = None,
                        butteraugli_iters: int = 0,
                        input_is_xyb: bool = False,
                        use_dc_frame: bool = False,
                        detect_dots: bool = False,
                        detect_patches: bool = False,
                        ctx_model: bool = False,
                        effort: int = None,
                        dc_distance: float = None,
                        group_order: int = 0,
                        center_x: int = None, center_y: int = None,
                        debug_cb=None, device=None) -> None:
    """Encode (3, H, W) linear RGB as a VarDCT frame (DCT8 strategy).

    Heuristics (vardct/heuristics.py): inverse Gaborish when the frame
    header enables the decoder-side blur, per-block adaptive quant field,
    per-tile chroma-from-luma fit — the round-1 subset of
    LossyFrameHeuristics (enc_heuristics.cc:1011-1206).

    device: a torch device runs the AC-strategy tile costs and the
    butteraugli quant refinement there (torch ops, the refinement's
    Gaborish + EPF through kernels.render_tail); None runs them on the
    host."""
    from ..api.frame import num_toc_entries
    from ..io.toc import write_group_offsets
    from ..ops.xyb import linear_rgb_to_xyb
    from .heuristics import apply_gaborish_inverse, fit_cfl, initial_quant_field

    fd = fh.frame_dimensions()
    state = VarDCTState(fh, fd)
    if custom_quant:
        # signaled (non-library) dequant matrices (enc_quant_weights.cc)
        for kind, entry in custom_quant.items():
            state.matrices.set_custom(kind, entry)
    if precomputed is not None:
        # device-computed encoding data (ops/pipeline.encode_step):
        # DCT8-only strategy, coefficients/DC/quant-field/CfL maps
        # arrive as arrays; only the section assembly runs on host.
        if splines is not None or patches is not None:
            raise JXLError(
                "precomputed path does not support splines/patches")
        quant_dc = initial_quant_dc(dc_distance or distance)
        if "quant_median" in precomputed:
            # reproduce the caller's global-scale anchor so the signaled
            # quantizer params match the precomputed field
            state.quantizer.compute_global_scale_and_quant(
                quant_dc, precomputed["quant_median"])
        else:
            state.quantizer.compute_global_scale_and_quant(
                quant_dc, K_AC_QUANT / distance)
        state.raw_quant_field = np.asarray(precomputed["qf"],
                                           dtype=np.int32)
        state.strategy[:, :] = acs.DCT
        state.is_origin[:, :] = True
        if fh.loop_filter.epf_iters > 0:
            state.epf_sharpness = np.asarray(
                precomputed.get("sharp", state.epf_sharpness * 0 + 4),
                dtype=np.int32)
        state.dc = np.asarray(precomputed["dc"], dtype=np.float64)
        state.ytox_map = np.asarray(precomputed["ytox_map"],
                                    dtype=np.int32)
        state.ytob_map = np.asarray(precomputed["ytob_map"],
                                    dtype=np.int32)
        if "qimg" in precomputed:
            # device already emitted image-layout i32 coefficients and
            # the (3, 64) per-position zero counts: no 100 MB host
            # transpose/astype of the block tensor
            qall_full = None
            qimg_pre = np.asarray(precomputed["qimg"], dtype=np.int32)
            nz_pre = np.asarray(precomputed["nz"], dtype=np.int64)
        else:
            qall_full = np.asarray(precomputed["qall"], dtype=np.int64)
            qimg_pre = nz_pre = None
        splines_state = None
        coeffs_q = None  # dense DCT8 grid: fast tokenization path
    else:
        h, w = rgb_linear.shape[-2:]
        # pad to block multiple by edge replication
        pad_y = fd.ysize_padded - h
        pad_x = fd.xsize_padded - w
        rgb = np.pad(rgb_linear, ((0, 0), (0, pad_y), (0, pad_x)), mode="edge")
        from ..io.frame_header import CT_NONE as _CT_NONE
        from ..io.frame_header import CT_YCBCR as _CT_YCBCR

        # encode-side pixel math is float32 when the input is (matching
        # the reference's float path, enc_xyb.cc / enc_group.cc); float64
        # inputs (explicit high-precision callers) keep float64
        _enc_dt = np.float32 if rgb.dtype == np.float32 else np.float64
        if input_is_xyb:
            xyb = rgb.astype(_enc_dt).copy()
        elif fh.color_transform == _CT_YCBCR:
            xyb = rgb_to_ycbcr(rgb)
        elif fh.color_transform == _CT_NONE:
            xyb = rgb.astype(_enc_dt).copy()
        else:
            xyb = linear_rgb_to_xyb(rgb)
        splines_state = None
        if splines is not None:
            # quantize splines and subtract their (decoder-visible) rendering
            # from the opsin image before the transform (enc_frame.cc analog:
            # splines.SubtractFrom happens ahead of gaborish inverse)
            from ..render.splines import (SplinesState, Spline, compute_segments,
                                          draw_segments, quantize_spline)

            if isinstance(splines, SplinesState):
                splines_state = splines
            else:
                splines_state = SplinesState()
                for sp in splines:
                    start = np.round(sp.control_points[0]).astype(int)
                    splines_state.starting_points.append(
                        (int(start[0]), int(start[1])))
                    splines_state.splines.append(
                        quantize_spline(sp, 0, 0.0, 1.0))
            segs = compute_segments(splines_state, fd.xsize_padded,
                                    fd.ysize_padded)
            draw_segments(xyb, segs, add=False)
            fh.flags |= FLAG_SPLINES
        if (detect_dots or detect_patches) and patches is None:
            # automatic patch extraction (FindBestPatchDictionary): text-like
            # patches first, dot extraction as the fallback; either becomes
            # an additive patch dictionary backed by a roundtripped
            # kReferenceOnly sheet coded in XYB space
            from ..render.patches import (
                BLEND_ADD,
                PatchBlending,
                PatchPosition,
                PatchReferencePosition,
                PatchesState,
                find_dots,
                find_text_patches,
            )
            from ..io.frame_header import FT_REFERENCE_ONLY

            found = None
            if detect_patches:
                found = find_text_patches(xyb[:, :fd.ysize, :fd.xsize])
            if found is None and detect_dots:
                found = find_dots(xyb[:, :fd.ysize, :fd.xsize])
            if found is not None:
                sheet, placements = found
                reffh = FrameHeader(fh.nonserialized_metadata)
                reffh.all_default = False
                reffh.frame_type = FT_REFERENCE_ONLY
                reffh.encoding = fh.encoding
                reffh.color_transform = fh.color_transform
                reffh.flags = FLAG_SKIP_ADAPTIVE_DC_SMOOTHING
                reffh.custom_size_or_origin = True
                reffh.frame_xsize = sheet.shape[2]
                reffh.frame_ysize = sheet.shape[1]
                reffh.save_as_reference = 0
                reffh.save_before_color_transform = True
                reffh.loop_filter.all_default = False
                reffh.loop_filter.gab = False
                reffh.loop_filter.epf_iters = 0
                tmp = BitWriter()
                encode_vardct_frame(tmp, sheet, reffh,
                                    distance=min(distance * 0.3, 0.3),
                                    input_is_xyb=True, adaptive_quant=False,
                                    ac_strategy_search=False,
                                    custom_orders=False)
                ref_bytes = tmp.get_bytes()
                rr = BitReader(ref_bytes)
                reffh2 = FrameHeader(fh.nonserialized_metadata)
                reffh2.read(rr)
                dec_sheet = decode_vardct_frame(rr, reffh2, return_xyb=True)
                writer.append_bytes(ref_bytes)
                writer.zero_pad_to_byte()
                st = PatchesState()
                st.blendings_stride = 1 + len(
                    fh.nonserialized_metadata.m.extra_channel_info)
                for (sx, sy, pw_, ph_, poses) in placements:
                    rp_idx = len(st.ref_positions)
                    st.ref_positions.append(
                        PatchReferencePosition(0, sx, sy, pw_, ph_))
                    for (x, y) in poses:
                        st.positions.append(PatchPosition(x, y, rp_idx))
                        st.blendings.append(
                            [PatchBlending(BLEND_ADD)]
                            * st.blendings_stride)
                patches = st
                reference_frames = [dec_sheet, None, None, None]
        if patches is not None:
            # inverse of the decoder's patches stage (which runs before the
            # splines stage, so the encoder subtracts after splines)
            from ..render.patches import apply_patches

            apply_patches(xyb, patches, reference_frames, add=False)
            fh.flags |= FLAG_PATCHES
        xyb_orig = xyb.copy() if butteraugli_iters > 0 else None
        # DC precision follows the PUBLIC distance (InitialQuantDC,
        # enc_adaptive_quantization.cc:1251-1263): the AC-field
        # calibration must not also refine the DC quantizer
        quant_dc = initial_quant_dc(dc_distance or distance)
        qf_float = None
        if adaptive_quant:
            # full adaptive quantization map (AdaptiveQuantizationMap,
            # enc_adaptive_quantization.cc) on the PRE-sharpening image
            # ("relies on pre-gaborish values", enc_heuristics.cc:1105);
            # global scale from the fixed 0.39/distance anchor the
            # reference uses outside the Butteraugli loop
            # (enc_heuristics.cc:1115)
            from .heuristics import initial_quant_field_full

            d_iqf = distance if fh.loop_filter.gab else distance * 0.62
            qf_float = initial_quant_field_full(
                xyb, fd.ysize_blocks, fd.xsize_blocks, d_iqf)
        if fh.loop_filter.gab:
            xyb = apply_gaborish_inverse(xyb)
        if adaptive_quant:
            state.quantizer.compute_global_scale_and_quant(
                quant_dc, K_GLOBAL_SCALE_QUANT / distance)
            state.raw_quant_field = np.clip(
                qf_float * state.quantizer.inv_global_scale + 0.5,
                1, QUANT_MAX).astype(np.int32)
        else:
            # SetQuant path (quantizer.cc:112-115): uniform field
            quant_ac = K_AC_QUANT / distance
            state.quantizer.compute_global_scale_and_quant(quant_dc,
                                                           quant_ac)
            raw_qf = max(1, min(QUANT_MAX, int(
                quant_ac * state.quantizer.inv_global_scale + 0.5)))
            state.raw_quant_field[:, :] = raw_qf
        state.strategy[:, :] = acs.DCT
        state.is_origin[:, :] = True
        # effort ladder: e3 = DCT8 only (doc/encode_effort.md), e4 =
        # simple variable blocks (<=16px), e5/e6 = transforms up to
        # 64x64 (enc_ac_strategy.cc:1060-1066 acs_mask below
        # DCT128X128), e7+ extends to the 128/256 giants (our
        # extension; the reference's merge heuristic stops at 64)
        acs_on = ac_strategy_search and (effort is None or effort >= 4)
        if acs_on and min(fd.ysize_blocks, fd.xsize_blocks) >= 2:
            if effort is None or effort >= 7:
                max_px = 256
            else:
                max_px = {4: 16, 5: 64, 6: 64}[max(4, min(6, effort))]
            _choose_ac_strategies(state, xyb, max_px=max_px,
                                  effort=effort,
                                  bt_target=dc_distance or distance / 0.7,
                                  device=device)
            _adjust_quant_field(state, dc_distance or distance)
        if fh.loop_filter.epf_iters > 0:
            from .heuristics import epf_sharpness_field

            state.epf_sharpness = epf_sharpness_field(
                xyb[1], fd.ysize_blocks, fd.xsize_blocks)
        if butteraugli_iters > 0:
            # after the strategy choice and EPF field, like the reference
            # dependency graph (enc_heuristics.cc:1060-1074:
            # ... -> ACS -> EPF -> quant field)
            from .heuristics import refine_quant_field

            refine_quant_field(state, xyb, xyb_orig, distance,
                               iters=butteraugli_iters, device=device)
        if ctx_model:
            # cluster (order class, quant bucket) cells into block
            # contexts (FindBestBlockEntropyModel, enc_heuristics.cc:1208)
            from .ctx import find_best_block_entropy_model

            state.block_ctx_map = find_best_block_entropy_model(
                state.raw_quant_field, state.strategy, state.is_origin,
                state.nonserialized_distance
                if hasattr(state, "nonserialized_distance") else distance)
        # DC = DCT DC coefficients = 8x8 block means
        if use_dc_frame:
            # DC-frame pyramid (kUseDcFrame, frame_header.h:348): the
            # frame's DC is a separately-coded 1:8 kDCFrame; roundtrip it
            # so the encoder sees exactly what the decoder will use.
            from ..io.frame_header import FT_DC

            dc_means = xyb.reshape(3, fd.ysize_blocks, 8, fd.xsize_blocks,
                                   8).mean(axis=(2, 4))
            dcfh = FrameHeader(fh.nonserialized_metadata)
            dcfh.all_default = False
            dcfh.frame_type = FT_DC
            dcfh.dc_level = 1
            dcfh.encoding = fh.encoding
            dcfh.color_transform = fh.color_transform
            dcfh.flags = FLAG_SKIP_ADAPTIVE_DC_SMOOTHING
            dcfh.is_last = False
            dcfh.loop_filter.all_default = False
            dcfh.loop_filter.gab = False
            dcfh.loop_filter.epf_iters = 0
            tmp = BitWriter()
            encode_vardct_frame(tmp, dc_means, dcfh,
                                distance=max(0.1, distance * 0.2),
                                input_is_xyb=True, adaptive_quant=False,
                                ac_strategy_search=False,
                                custom_orders=False)
            dc_bytes = tmp.get_bytes()
            rr = BitReader(dc_bytes)
            dcfh2 = FrameHeader(fh.nonserialized_metadata)
            dcfh2.read(rr)
            dec_dc = decode_vardct_frame(rr, dcfh2, return_xyb=True)
            writer.append_bytes(dc_bytes)
            writer.zero_pad_to_byte()
            fh.flags |= FLAG_USE_DC_FRAME
            state.dc = np.asarray(
                dec_dc[:, :fd.ysize_blocks, :fd.xsize_blocks],
                dtype=np.float64)
        else:
            state.dc = xyb.reshape(
                3, fd.ysize_blocks, 8, fd.xsize_blocks, 8).mean(axis=(2, 4))
        # quantize AC coefficients (vectorized over the whole block grid —
        # mirrors enc_group.cc ComputeCoefficients, batched like the TPU path)
        inv_gs = state.quantizer.inv_global_scale
        nby, nbx = fd.ysize_blocks, fd.xsize_blocks
        kind = acs.QUANT_TABLE[acs.DCT]
        dt = xyb.dtype
        dm_inv = np.stack([state.matrices.inv_matrix(kind, c)
                           for c in range(3)]).astype(dt)  # (3,8,8), LLF 0
        dm_y = state.matrices.dequant_matrix(kind, 1).astype(dt)
        blocks = xyb.reshape(3, nby, 8, nbx, 8).transpose(0, 1, 3, 2, 4)
        from ..ops.dct import fwd_matrix

        f8 = fwd_matrix(8).astype(dt)
        # swap (u, v) at the end: coefficients are stored transposed
        # ([hfreq][vfreq]), matching ComputeScaledDCT's square layout
        co = np.einsum("ur,cnmrk,vk->cnmvu", f8, blocks, f8,
                   optimize=True)
        scaled = (inv_gs / state.raw_quant_field.astype(dt))[
            None, :, :, None, None]
        qy = quantize_deadzone(co[1] * dm_inv[1] / scaled[0], 1, 1, 1)
        dy = adjust_quant_bias(qy, 1) * dm_y * scaled[0]
        if cfl:
            state.ytox_map, state.ytob_map = fit_cfl(co[0], co[1], co[2],
                                                     nby, nbx)
        x_cc = (state.base_x + np.repeat(np.repeat(
            state.ytox_map, 8, 0), 8, 1)[:nby, :nbx]
            / state.color_factor)[:, :, None, None].astype(dt)
        b_cc = (state.base_b + np.repeat(np.repeat(
            state.ytob_map, 8, 0), 8, 1)[:nby, :nbx]
            / state.color_factor)[:, :, None, None].astype(dt)
        qx = quantize_deadzone((co[0] - x_cc * dy) * dm_inv[0]
                               / (scaled[0] * state.x_dm_mult), 1, 1, 0)
        qb = quantize_deadzone((co[2] - b_cc * dy) * dm_inv[2]
                               / (scaled[0] * state.b_dm_mult), 1, 1, 2)
        qall = np.stack([qx, qy, qb]).astype(np.int64)
        qall[:, :, :, 0, 0] = 0  # LLF not coded
        qall_full = qall
        qimg_pre = nz_pre = None
        if bool((state.strategy == acs.DCT).all()):
            coeffs_q = None  # dense DCT8 grid: fast tokenization path
        else:
            coeffs_q = {}
        for by in range(nby if coeffs_q is not None else 0):
            for bx in range(nbx):
                if not state.is_origin[by, bx]:
                    continue
                strategy = int(state.strategy[by, bx])
                if strategy == acs.DCT:
                    coeffs_q[(by, bx)] = qall[:, by, bx].reshape(3, 64)
                    continue
                # multi-block / special transform: recompute coefficients
                cx_, cy_ = acs.COVERED_X[strategy], acs.COVERED_Y[strategy]
                cb = cx_ * cy_
                kind2 = acs.QUANT_TABLE[strategy]
                dmi = np.stack([state.matrices.inv_matrix(kind2, c).reshape(-1)
                                for c in range(3)])
                dm_y2 = state.matrices.dequant_matrix(kind2, 1).reshape(-1)
                quant = int(state.raw_quant_field[by, bx])
                sc = inv_gs / quant
                block = xyb[:, by * 8:(by + cy_) * 8, bx * 8:(bx + cx_) * 8]
                co2 = np.stack([
                    transform_from_pixels(strategy, block[c]).reshape(-1)
                    for c in range(3)])
                wr2 = min(cy_, cx_) * 8
                wc2 = max(cy_, cx_) * 8

                def _dz(vals, ch):
                    return quantize_deadzone(
                        vals.reshape(wr2, wc2), cy_, cx_, ch).reshape(-1)

                qy2 = _dz(co2[1] * dmi[1] / sc, 1)
                dy2 = adjust_quant_bias(qy2, 1) * dm_y2 * sc
                xcc = float(x_cc[by, bx, 0, 0])
                bcc = float(b_cc[by, bx, 0, 0])
                qx2 = _dz((co2[0] - xcc * dy2) * dmi[0]
                          / (sc * state.x_dm_mult), 0)
                qb2 = _dz((co2[2] - bcc * dy2) * dmi[2]
                          / (sc * state.b_dm_mult), 2)
                q2 = np.stack([qx2, qy2, qb2]).astype(np.int64)
                # LLF positions (wide layout [:min, :max]) are not coded; also
                # update the DC image from the transform's LLF so the decoder
                # reconstructs the same low frequencies
                rows2 = min(cy_, cx_) * 8
                cols2 = max(cy_, cx_) * 8
                llf_mask = np.zeros((rows2, cols2), dtype=bool)
                llf_mask[:min(cy_, cx_), :max(cy_, cx_)] = True
                q2[:, llf_mask.reshape(-1)] = 0
                for c in range(3):
                    llf = co2[c].reshape(rows2, cols2)[
                        :min(cy_, cx_), :max(cy_, cx_)]
                    state.dc[c, by:by + cy_, bx:bx + cx_] = \
                        dc_from_lowest_frequencies(strategy, llf)
                coeffs_q[(by, bx)] = q2
    # global modular tree for the DC/metadata substreams; tokenized AFTER
    # the CfL fit so the AC-metadata stream carries the fitted tile maps.
    # e4+ learns the tree over the quantized-DC samples (enc_modular.cc
    # ComputeEncodingData learned-tree tier) — on smooth content the
    # fixed Gradient tree pays ~1.5 bits for every +-1 dither residual
    # the learned context tree codes in a fraction of that.
    tree = None
    if effort is not None and effort >= 4 \
            and not (fh.flags & FLAG_USE_DC_FRAME):
        from ..modular.learn import learn_tree

        fac = [state.quantizer.mul_dc(c) for c in range(3)]
        cfl_x, cfl_b = state.cfl_dc_factors()
        qy_l = np.round(state.dc[1] / fac[1])
        dy_l = qy_l * fac[1]
        qx_l = np.round((state.dc[0] - cfl_x * dy_l) / fac[0])
        qb_l = np.round((state.dc[2] - cfl_b * dy_l) / fac[2])
        learn_channels = [
            (qy_l.astype(np.int32), 0, 1),
            (qx_l.astype(np.int32), 1, 1),
            (qb_l.astype(np.int32), 2, 1),
        ]
        step = 1 if state.dc[0].size <= (1 << 16) else 2
        tree = learn_tree(learn_channels, sample_step=step)
    if tree is None:
        tree = make_fixed_tree(P_GRADIENT)
    tree_writer = BitWriter()
    dec_tree = encode_tree(tree, tree_writer)
    wp_header = GroupHeader().wp_header
    # tokenize DC groups (also replaces state.dc with dequantized values)
    dc_streams = []
    for g in range(fd.num_dc_groups):
        dc_streams.append(tokenize_dc_group(state, g, dec_tree, wp_header))
    # --- extra channels: modular-coded sub-streams of the VarDCT frame
    # (enc_modular.cc ComputeEncodingData with do_color=false)
    from ..api.frame import (
        ModularFrameState,
        _channel_brackets,
        _group_channel_list,
        get_downsampling_bracket,
        modular_ac_stream_id,
    )

    ec_global_tokens = []
    ec_ac_tokens = {}  # (pass, group) -> tokens
    ec_image = None
    if extra_channels:
        ec_image = ModularImage(
            fd.xsize, fd.ysize,
            fh.nonserialized_metadata.m.bit_depth.bits_per_sample, 0)
        from ..modular.image import Channel as MChannel

        ec_image.channel = [
            MChannel(a.shape[1], a.shape[0], 0, 0, a.astype(np.int32))
            for a in extra_channels]
        beginc = _channel_brackets(ec_image, fd.group_dim)
        gtmp = ModularImage(fd.xsize, fd.ysize, ec_image.bitdepth, 0)
        gtmp.channel = ec_image.channel[:beginc]
        for i in range(len(gtmp.channel)):
            _tokenize_channel(gtmp, i, 0, dec_tree, wp_header,
                              ec_global_tokens)
        ec_state = ModularFrameState()
        ec_state.full_image = ec_image
        for p in range(fh.passes.num_passes):
            min_shift, max_shift = get_downsampling_bracket(fh.passes, p)
            for g in range(fd.num_groups):
                gx, gy = g % fd.xsize_groups, g // fd.xsize_groups
                rect = (gx * fd.group_dim, gy * fd.group_dim, fd.group_dim,
                        fd.group_dim)
                chans = _group_channel_list(ec_state, fd, rect, min_shift,
                                            max_shift)
                if not chans:
                    continue
                sid = modular_ac_stream_id(fd, g, p)
                gi = ModularImage(1, 1, ec_image.bitdepth, 0)
                for (c, rx0, ry0, rw, rh) in chans:
                    fc = ec_image.channel[c]
                    gi.channel.append(MChannel(
                        rw, rh, fc.hshift, fc.vshift,
                        fc.data[ry0:ry0 + rh, rx0:rx0 + rw].copy()))
                toks = []
                for i in range(len(gi.channel)):
                    _tokenize_channel(gi, i, sid, dec_tree, wp_header, toks)
                ec_ac_tokens[(p, g)] = toks

    modular_token_lists = [ec_global_tokens]  # global stream
    for dc_tokens, meta_tokens, _ in dc_streams:
        modular_token_lists.append(dc_tokens)
        modular_token_lists.append(meta_tokens)
    modular_token_lists.extend(ec_ac_tokens.values())
    histo_writer = BitWriter()
    codes, context_map = build_and_encode_histograms(
        modular_token_lists, num_tree_contexts(dec_tree), histo_writer)

    num_passes = fh.passes.num_passes
    bcm = state.block_ctx_map
    if coeffs_q is None:
        # fast-path eligibility: single pass, default DC conditioning,
        # native tokenizer present
        from ..native_ext import get_lib

        _nlib = get_lib()
        if (num_passes != 1 or bcm.num_dc_ctxs != 1 or _nlib is None
                or not hasattr(_nlib, "tokenize_ac_image")):
            if qall_full is None:  # rebuild blocks from image layout
                nby_, nbx_ = fd.ysize_blocks, fd.xsize_blocks
                qall_full = np.ascontiguousarray(
                    qimg_pre.reshape(3, nby_, 8, nbx_, 8).transpose(
                        0, 1, 3, 2, 4)).astype(np.int64)
            coeffs_q = {}
            for by in range(fd.ysize_blocks):
                for bx in range(fd.xsize_blocks):
                    coeffs_q[(by, bx)] = qall_full[:, by, bx].reshape(3, 64)
    from .coeff_order import compute_coeff_orders, encode_coeff_orders

    # use default orders for small images (enc_coeff_order.cc:71-72)
    customize = custom_orders and (fd.xsize_blocks >= 5
                                   or fd.ysize_blocks >= 5)
    if coeffs_q is None:
        # dense DCT8 path: vectorized zero counts + native tokenization
        # over the whole group grid (TokenizeCoefficients pthread-pool
        # analog, enc_frame.cc:1125)
        import os as _os

        from ..entropy.encode import TokenArray
        from ..native_ext import tokenize_ac_image_native

        nby, nbx = fd.ysize_blocks, fd.xsize_blocks
        used_strategies = {acs.DCT}
        if nz_pre is not None:
            nz = nz_pre
        else:
            nz = (qall_full == 0).sum(axis=(1, 2)).reshape(3, 64).astype(
                np.int64)
        num_zeros = {(acs.STRATEGY_ORDER[acs.DCT], c): nz[c]
                     for c in range(3)}
        used_p, orders_p = compute_coeff_orders(
            num_zeros, used_strategies, customize=customize)
        pass_orders = [(used_p, orders_p)]
        qimg_enc = qimg_pre if qimg_pre is not None \
            else np.ascontiguousarray(
                qall_full.transpose(0, 1, 3, 2, 4).reshape(
                    3, nby * 8, nbx * 8).astype(np.int32))
        bctx_lut, qf_thr = _bctx_luts(bcm)
        cov_x, cov_y, log2cb, ord_lut = _geometry_luts()
        off_tab, oflat = _order_image_luts(
            [acs.DCT], lambda o, c: orders_p.get((o, c)), nbx * 8)
        strat32 = np.ascontiguousarray(state.strategy, dtype=np.int32)
        qf32 = np.ascontiguousarray(state.raw_quant_field,
                                    dtype=np.int32)
        orig = np.ascontiguousarray(state.is_origin, dtype=np.bool_)
        toks = tokenize_ac_image_native(
            _nlib, fd.xsize_groups, fd.ysize_groups, fd.group_dim // 8,
            (strat32, orig, qf32),
            (bctx_lut, qf_thr, off_tab, oflat,
             cov_x, cov_y, log2cb, ord_lut),
            bcm.num_ctxs, [qimg_enc[0], qimg_enc[1], qimg_enc[2]],
            n_threads=_os.cpu_count() or 1)
        group_token_lists = [[[TokenArray(c_, u_)] for (c_, u_) in toks]]
    else:
        shifts = [fh.passes.shift[p] for p in range(num_passes)] \
            if num_passes > 1 else [0]
        pass_coeffs = [dict() for _ in range(num_passes)]
        for key, q in coeffs_q.items():
            parts = split_progressive(q, shifts)
            for p in range(num_passes):
                pass_coeffs[p][key] = parts[p]
        # custom coefficient orders per pass (ComputeCoeffOrder analog):
        # count zeros per position over all blocks of each order class
        used_strategies = {int(state.strategy[by, bx])
                           for (by, bx) in coeffs_q}
        pass_orders = []
        for p in range(num_passes):
            num_zeros = {}
            for (by, bx), q in pass_coeffs[p].items():
                s = int(state.strategy[by, bx])
                ord_ = acs.STRATEGY_ORDER[s]
                for c in range(3):
                    key = (ord_, c)
                    if key not in num_zeros:
                        num_zeros[key] = np.zeros(q.shape[1],
                                                  dtype=np.int64)
                    num_zeros[key] += (q[c] == 0)
            used_p, orders_p = compute_coeff_orders(
                num_zeros, used_strategies, customize=customize)
            pass_orders.append((used_p, orders_p))
        group_token_lists = None
        from ..native_ext import get_lib

        _nlib = get_lib()
        if (num_passes == 1 and bcm.num_dc_ctxs == 1 and _nlib is not None
                and hasattr(_nlib, "tokenize_ac_image")):
            # mixed-strategy native tokenization: scatter every block's
            # wide-layout coefficients into the dense image layout and
            # run the C tokenizer (it walks arbitrary strategies via
            # the geometry/order LUTs) — same tokens as the Python
            # per-group path, one pass, thread-pooled
            import os as _os

            from ..entropy.encode import TokenArray
            from ..native_ext import tokenize_ac_image_native

            nby, nbx = fd.ysize_blocks, fd.xsize_blocks
            qimg_enc = np.zeros((3, nby * 8, nbx * 8), dtype=np.int32)
            q5 = qimg_enc.reshape(3, nby, 8, nbx, 8)
            by_strategy = {}
            for key in coeffs_q:
                by_strategy.setdefault(
                    int(state.strategy[key[0], key[1]]), []).append(key)
            for s, keys in by_strategy.items():
                cx, cy = acs.COVERED_X[s], acs.COVERED_Y[s]
                vals = np.stack([np.asarray(coeffs_q[k]) for k in
                                 keys]).astype(np.int32)
                if cy == 1 and cx == 1:
                    ks = np.array(keys, dtype=np.int64)
                    q5[:, ks[:, 0], :, ks[:, 1], :] = \
                        vals.reshape(-1, 3, 8, 8)
                else:
                    for (by, bx), v in zip(keys, vals):
                        qimg_enc[:, by * 8:(by + cy) * 8,
                                 bx * 8:(bx + cx) * 8] = \
                            v.reshape(3, cy * 8, cx * 8)
            bctx_lut, qf_thr = _bctx_luts(bcm)
            cov_x, cov_y, log2cb, ord_lut = _geometry_luts()
            orders_p = pass_orders[0][1]
            off_tab, oflat = _order_image_luts(
                sorted(used_strategies),
                lambda o, c: orders_p.get((o, c)), nbx * 8)
            strat32 = np.ascontiguousarray(state.strategy,
                                           dtype=np.int32)
            qf32 = np.ascontiguousarray(state.raw_quant_field,
                                        dtype=np.int32)
            orig = np.ascontiguousarray(state.is_origin, dtype=np.bool_)
            toks = tokenize_ac_image_native(
                _nlib, fd.xsize_groups, fd.ysize_groups,
                fd.group_dim // 8, (strat32, orig, qf32),
                (bctx_lut, qf_thr, off_tab, oflat,
                 cov_x, cov_y, log2cb, ord_lut),
                bcm.num_ctxs, [qimg_enc[0], qimg_enc[1], qimg_enc[2]],
                n_threads=_os.cpu_count() or 1)
            group_token_lists = [[[TokenArray(c_, u_)]
                                  for (c_, u_) in toks]]
        if group_token_lists is None:
            group_token_lists = [
                [tokenize_ac_group(state, g, pass_coeffs[p],
                                   pass_orders[p][1])
                 for g in range(fd.num_groups)]
                for p in range(num_passes)]

    num_contexts = state.block_ctx_map.num_ac_contexts()
    ac_token_lists = []  # [pass][group]
    ac_codes = []
    ac_context_maps = []
    ac_histo_writers = []
    for p in range(num_passes):
        group_tokens = group_token_lists[p]
        hw = BitWriter()
        codes_p, cmap_p = build_and_encode_histograms(
            group_tokens, num_contexts, hw)
        ac_token_lists.append(group_tokens)
        ac_codes.append(codes_p)
        ac_context_maps.append(cmap_p)
        ac_histo_writers.append(hw)

    # --- assemble sections
    def write_dc_global(w):
        # image features, in reference order: patches, splines, noise
        # (dec_frame.cc:269-292)
        if fh.flags & FLAG_PATCHES:
            from ..render.patches import encode_patches

            encode_patches(patches, w)
        if fh.flags & FLAG_SPLINES:
            from ..render.splines import encode_splines

            encode_splines(splines_state, w)
        if fh.flags & FLAG_NOISE:
            from ..render.noise import encode_noise

            encode_noise(noise_lut, w)
        state.matrices.encode_dc(w)
        state.quantizer.encode(w)
        from .ctx import encode_block_ctx_map

        encode_block_ctx_map(state.block_ctx_map, w)
        encode_cmap_dc_default(w)
        # modular global info: has_tree=1, tree, histograms, global image
        w.write(1, 1)
        w.append_bits_from(tree_writer)
        w.append_bits_from(histo_writer)
        # Without extra channels the global modular image has zero
        # channels and ModularEncode writes NOTHING (enc_encoding.cc:
        # 562-564) — not even the GroupHeader. With extra channels, the
        # GroupHeader is always present; channels <= group_dim are coded
        # here, larger ones per AC group.
        if ec_image is not None:
            gh = GroupHeader()
            gh.use_global_tree = True
            gh.write(w)
            if ec_global_tokens:
                write_tokens(ec_global_tokens, codes, context_map, w)

    def write_dc_group(w, g):
        dc_tokens, meta_tokens, count = dc_streams[g]
        if not (fh.flags & FLAG_USE_DC_FRAME):
            w.write(2, 0)  # extra_precision
            gh = GroupHeader()
            gh.use_global_tree = True
            gh.write(w)
            write_tokens(dc_tokens, codes, context_map, w)
        # ModularDC group: no channels -> nothing
        x0, y0, rw, rh = fd.dc_group_rect(g)
        upper_bound = rw * rh
        nbits = (upper_bound - 1).bit_length() if upper_bound > 1 else 0
        if nbits:
            w.write(nbits, count - 1)
        gh2 = GroupHeader()
        gh2.use_global_tree = True
        gh2.write(w)
        write_tokens(meta_tokens, codes, context_map, w)

    def write_ac_global(w):
        state.matrices.encode(w, num_dc_groups=fd.num_dc_groups)
        nbits = (fd.num_groups - 1).bit_length() if fd.num_groups > 1 else 0
        if nbits:
            w.write(nbits, 0)  # num_histograms - 1
        for p in range(num_passes):
            used_p, orders_p = pass_orders[p]
            u32_write(ORDER_ENC, used_p, w)
            encode_coeff_orders(used_p, orders_p, w)
            w.append_bits_from(ac_histo_writers[p])

    def write_ac_group(w, g, p=0):
        write_tokens(ac_token_lists[p][g], ac_codes[p], ac_context_maps[p], w,
                     pretok=(ac_codes[p].tokenized[g]
                             if ac_codes[p].tokenized is not None else None))
        if (p, g) in ec_ac_tokens:
            gh = GroupHeader()
            gh.use_global_tree = True
            gh.write(w)
            write_tokens(ec_ac_tokens[(p, g)], codes, context_map, w)

    if debug_cb is not None:
        # JxlEncoderSetDebugImageCallback analog: expose the heuristic
        # fields (quant field, sharpness, strategies, CfL maps)
        debug_cb(state)
    single = fd.num_groups == 1 and fh.passes.num_passes == 1
    sections = []
    layers = writer.layer_bits

    def acc(layer, nbits):
        layers[layer] = layers.get(layer, 0) + nbits

    if single:
        w = BitWriter()
        write_dc_global(w)
        acc("dc_global", w.bits_written())
        b0 = w.bits_written()
        write_dc_group(w, 0)
        acc("dc_groups", w.bits_written() - b0)
        b0 = w.bits_written()
        write_ac_global(w)
        acc("ac_global", w.bits_written() - b0)
        b0 = w.bits_written()
        write_ac_group(w, 0)
        acc("ac_groups", w.bits_written() - b0)
        sections.append(w.get_bytes())
    else:
        w = BitWriter()
        write_dc_global(w)
        acc("dc_global", w.bits_written())
        sections.append(w.get_bytes())
        for g in range(fd.num_dc_groups):
            w = BitWriter()
            write_dc_group(w, g)
            acc("dc_groups", w.bits_written())
            sections.append(w.get_bytes())
        w = BitWriter()
        write_ac_global(w)
        acc("ac_global", w.bits_written())
        sections.append(w.get_bytes())
        for p in range(num_passes):
            for g in range(fd.num_groups):
                w = BitWriter()
                write_ac_group(w, g, p)
                acc("ac_groups", w.bits_written())
                sections.append(w.get_bytes())
    b0 = writer.bits_written()
    fh.write(writer)
    acc("frame_header", writer.bits_written() - b0)
    perm = None
    if group_order == 1 and fd.num_groups > 1 and len(sections) > 1:
        # kCenterFirst TOC permutation (cjxl --group_order): AC group
        # sections stream in order of distance from (center_x,
        # center_y); fixed sections keep their positions. The signaled
        # permutation maps natural section index -> stream position
        # (toc.cc:94-105 inverse application on read).
        cx = (fd.xsize / 2.0) if center_x is None else float(center_x)
        cy = (fd.ysize / 2.0) if center_y is None else float(center_y)
        fixed = 2 + fd.num_dc_groups

        def dist(g):
            gx = (g % fd.xsize_groups + 0.5) * fd.group_dim
            gy = (g // fd.xsize_groups + 0.5) * fd.group_dim
            return (gx - cx) ** 2 + (gy - cy) ** 2

        order = sorted(range(fd.num_groups), key=dist)
        stream_natural = list(range(fixed)) + [
            fixed + p * fd.num_groups + g
            for p in range(num_passes) for g in order]
        perm = [0] * len(stream_natural)
        for pos, nat in enumerate(stream_natural):
            perm[nat] = pos
        sections = [sections[nat] for nat in stream_natural]
    write_group_offsets([len(s) for s in sections], perm, writer)
    writer.zero_pad_to_byte()
    for s in sections:
        writer.append_bytes(s)
