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

from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from ..io.fields import (
    Bits,
    BitsOffset,
    Bundle,
    U32Enc,
    Val,
    f16_read,
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
from ..entropy.encode import (
    TokenArray,
    build_and_encode_histograms,
    write_tokens,
)
from ..modular.codec import GroupHeader, ModularOptions, _tokenize_channel, modular_decode
from ..modular.image import Channel, ModularImage
from ..modular.predict import P_GRADIENT
from ..modular.tree import encode_tree, make_fixed_tree, num_tree_contexts
from . import ac_strategy as acs
from .ctx import BlockCtxMap, decode_block_ctx_map, QUANT_MAX
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
    if not blocks or not _decode_ac_group_native(r, state, reader, blocks, bx0,
                                           by0, bw, bh, ctx_offset, shift,
                                           pass_idx):
        raise JXLError("an AC group the native decoder declines (LZ77, "
                       "prefix codes): not in this copy")
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
                       global_ctx_map=state.context_map)
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
                   global_ctx_map=state.context_map)
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


def decode_vardct_frame(r: BitReader, fh: FrameHeader):
    """Decode a VarDCT frame (header already read) -> (3, H, W) XYB-decoded
    linear RGB channels list. The frame is XYB with no DC frame, patches,
    splines, noise, upsampling or extra channel: the frames encode_lossy
    makes."""
    from ..api.frame import decode_frame_sections
    from ..api.frame import decode_global_info, decode_modular_group
    from ..api.frame import ModularFrameState
    from ..api.frame import modular_dc_stream_id
    from ..io.frame_header import CT_XYB
    from ..ops.xyb import xyb_to_linear_rgb

    if (fh.color_transform != CT_XYB
            or fh.flags & (FLAG_USE_DC_FRAME | FLAG_PATCHES | FLAG_SPLINES
                           | FLAG_NOISE)
            or fh.upsampling > 1
            or fh.nonserialized_metadata.m.num_extra_channels):
        raise JXLError("a DC frame, patches, splines, noise, upsampling, "
                       "extra channels or no XYB: not in this copy")
    fd = fh.frame_dimensions()
    state = VarDCTState(fh, fd)
    state.want_qimg = False
    mstate = ModularFrameState()

    def dc_global(sr):
        state.matrices.decode_dc(sr)
        state.quantizer.decode(sr)
        state.block_ctx_map = decode_block_ctx_map(sr)
        decode_cmap_dc(sr, state)
        decode_global_info(sr, fh, fd, mstate)
        state.tree = mstate.tree
        state.code = mstate.code
        state.context_map = mstate.context_map

    def dc_group(g, sr):
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
        state.matrices.decode(sr)
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
        decode_ac_group(sr, state, g, p)

    def ac_bulk(data, per_pass):
        return decode_ac_bulk_native(state, data, per_pass)

    decode_frame_sections(r, fh, dc_global, dc_group, ac_global, ac_group,
                          decode_ac_bulk=ac_bulk)
    render_groups(state)
    # render: XYB -> linear RGB (gaborish/EPF handled by render pipeline
    # when enabled)
    if fh.loop_filter.gab or fh.loop_filter.epf_iters > 0:
        from ..render.pipeline import apply_restoration

        state.xyb = apply_restoration(state.xyb, fh, state)
    rgb = xyb_to_linear_rgb(state.xyb[:, :fd.ysize, :fd.xsize])
    return [rgb[c] for c in range(3)]


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


_INFO_LOSS_MUL = 320.0  # tuned: RD-dominates DCT8-only on noisy
# content while leaving smooth-content merges untouched (see commit)


def _batched_tile_cost(state: VarDCTState, xyb: np.ndarray, rows: int,
                       cols: int, kind: int) -> np.ndarray:
    """Estimated coding cost of covering the image with rows x cols px
    transforms: -> f64[nby//(rows//8), nbx//(cols//8)] (edge-partial tiles
    excluded). Vectorized EstimateEntropy analog (enc_ac_strategy.cc:361):
    2 bits per nonzero + magnitude bits + per-channel nzeros overhead."""
    from ..ops.dct import fwd_matrix

    fd = state.fd
    nby, nbx = fd.ysize_blocks, fd.xsize_blocks
    cy, cx = rows // 8, cols // 8
    tby, tbx = nby // cy, nbx // cx
    if tby == 0 or tbx == 0:
        return np.full((tby, tbx), np.inf)
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
                          bt_target: float = None) -> None:
    """Merge-family AC strategy search: per 32x32 supertile choose among
    DCT8 / DCT16X8 / DCT8X16 / DCT16X16 / DCT32X32 by estimated token
    cost (FindBest8x8Transform + TryMergeAcs +
    FindBestFirstLevelDivisionForSquare, enc_ac_strategy.cc:496-810,
    batched over the whole grid instead of sequential merging).

    max_px caps the merge ladder (effort tiers, doc/encode_effort.md:
    e4 "simple variable blocks" stops at 16, e5 at 32, e6+ runs the
    full ladder).
    """
    fd = state.fd
    nby, nbx = fd.ysize_blocks, fd.xsize_blocks
    c8 = _batched_tile_cost(state, xyb, 8, 8, acs.QUANT_TABLE[acs.DCT])
    c16 = _batched_tile_cost(state, xyb, 16, 16,
                             acs.QUANT_TABLE[acs.DCT16X16])
    c16x8 = _batched_tile_cost(state, xyb, 16, 8,
                               acs.QUANT_TABLE[acs.DCT16X8])
    c8x16 = _batched_tile_cost(state, xyb, 8, 16,
                               acs.QUANT_TABLE[acs.DCT8X16])
    want32 = max_px >= 32
    c32 = c32x16 = c16x32 = None
    if want32:
        c32 = _batched_tile_cost(state, xyb, 32, 32,
                                 acs.QUANT_TABLE[acs.DCT32X32])
        c32x16 = _batched_tile_cost(state, xyb, 32, 16,
                                    acs.QUANT_TABLE[acs.DCT32X16])
        c16x32 = _batched_tile_cost(state, xyb, 16, 32,
                                    acs.QUANT_TABLE[acs.DCT16X32])
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
                                 acs.QUANT_TABLE[acs.DCT64X64])
        c64x32 = _batched_tile_cost(state, xyb, 64, 32,
                                    acs.QUANT_TABLE[acs.DCT64X32])
        c32x64 = _batched_tile_cost(state, xyb, 32, 64,
                                    acs.QUANT_TABLE[acs.DCT32X64])
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
                                  acs.QUANT_TABLE[acs.DCT128X128])
        c128x64 = _batched_tile_cost(state, xyb, 128, 64,
                                     acs.QUANT_TABLE[acs.DCT128X64])
        c64x128 = _batched_tile_cost(state, xyb, 64, 128,
                                     acs.QUANT_TABLE[acs.DCT64X128])
    if big256:
        c256 = _batched_tile_cost(state, xyb, 256, 256,
                                  acs.QUANT_TABLE[acs.DCT256X256])
        c256x128 = _batched_tile_cost(state, xyb, 256, 128,
                                      acs.QUANT_TABLE[acs.DCT256X128])
        c128x256 = _batched_tile_cost(state, xyb, 128, 256,
                                      acs.QUANT_TABLE[acs.DCT128X256])

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
                        effort: int = None,
                        dc_distance: float = None) -> None:
    """Encode (3, H, W) linear RGB as a VarDCT frame in XYB.

    Heuristics (vardct/heuristics.py): inverse Gaborish when the frame
    header enables the decoder-side blur, per-block adaptive quant field,
    per-tile chroma-from-luma fit, the AC strategy search at efforts >= 4
    — the subset of LossyFrameHeuristics (enc_heuristics.cc:1011-1206)
    that efforts 1-6 run."""
    from ..io.toc import write_group_offsets
    from ..ops.xyb import linear_rgb_to_xyb
    from .heuristics import apply_gaborish_inverse, fit_cfl

    fd = fh.frame_dimensions()
    state = VarDCTState(fh, fd)
    h, w = rgb_linear.shape[-2:]
    # pad to block multiple by edge replication
    pad_y = fd.ysize_padded - h
    pad_x = fd.xsize_padded - w
    rgb = np.pad(rgb_linear, ((0, 0), (0, pad_y), (0, pad_x)), mode="edge")
    xyb = linear_rgb_to_xyb(rgb)
    # DC precision follows the PUBLIC distance (InitialQuantDC,
    # enc_adaptive_quantization.cc:1251-1263): the AC-field
    # calibration must not also refine the DC quantizer
    quant_dc = initial_quant_dc(dc_distance or distance)
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
    state.quantizer.compute_global_scale_and_quant(
        quant_dc, K_GLOBAL_SCALE_QUANT / distance)
    state.raw_quant_field = np.clip(
        qf_float * state.quantizer.inv_global_scale + 0.5,
        1, QUANT_MAX).astype(np.int32)
    state.strategy[:, :] = acs.DCT
    state.is_origin[:, :] = True
    # effort ladder: e3 = DCT8 only (doc/encode_effort.md), e4 =
    # simple variable blocks (<=16px), e5/e6 = transforms up to
    # 64x64 (enc_ac_strategy.cc:1060-1066 acs_mask below
    # DCT128X128)
    acs_on = effort is None or effort >= 4
    if acs_on and min(fd.ysize_blocks, fd.xsize_blocks) >= 2:
        max_px = {4: 16, 5: 64}[max(4, min(5, effort or 5))]
        _choose_ac_strategies(state, xyb, max_px=max_px,
                              effort=effort,
                              bt_target=dc_distance or distance / 0.7)
        _adjust_quant_field(state, dc_distance or distance)
    if fh.loop_filter.epf_iters > 0:
        from .heuristics import epf_sharpness_field

        state.epf_sharpness = epf_sharpness_field(
            xyb[1], fd.ysize_blocks, fd.xsize_blocks)
    # DC = DCT DC coefficients = 8x8 block means
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
    if effort is not None and effort >= 4:
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
    modular_token_lists = [[]]  # global stream: no channels
    for dc_tokens, meta_tokens, _ in dc_streams:
        modular_token_lists.append(dc_tokens)
        modular_token_lists.append(meta_tokens)
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
            coeffs_q = {}
            for by in range(fd.ysize_blocks):
                for bx in range(fd.xsize_blocks):
                    coeffs_q[(by, bx)] = qall_full[:, by, bx].reshape(3, 64)
    from .coeff_order import compute_coeff_orders, encode_coeff_orders

    # use default orders for small images (enc_coeff_order.cc:71-72)
    customize = fd.xsize_blocks >= 5 or fd.ysize_blocks >= 5
    if coeffs_q is None:
        # dense DCT8 path: vectorized zero counts + native tokenization
        # over the whole group grid (TokenizeCoefficients pthread-pool
        # analog, enc_frame.cc:1125)
        import os as _os

        from ..entropy.encode import TokenArray
        from ..native_ext import tokenize_ac_image_native

        nby, nbx = fd.ysize_blocks, fd.xsize_blocks
        used_strategies = {acs.DCT}
        nz = (qall_full == 0).sum(axis=(1, 2)).reshape(3, 64).astype(
            np.int64)
        num_zeros = {(acs.STRATEGY_ORDER[acs.DCT], c): nz[c]
                     for c in range(3)}
        used_p, orders_p = compute_coeff_orders(
            num_zeros, used_strategies, customize=customize)
        pass_orders = [(used_p, orders_p)]
        qimg_enc = np.ascontiguousarray(
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
            raise JXLError("the native AC tokenizer did not build")

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
        # 562-564) — not even the GroupHeader.

    def write_dc_group(w, g):
        dc_tokens, meta_tokens, count = dc_streams[g]
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
        state.matrices.encode(w)
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
    write_group_offsets([len(s) for s in sections], None, writer)
    writer.zero_pad_to_byte()
    for s in sections:
        writer.append_bytes(s)
