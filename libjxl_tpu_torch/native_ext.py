"""ctypes loader for the native C hot loops of the host layers
(native/*.c: AC and modular entropy decode, AC tokenization, the rANS
writer, the LZ77 match search, the JPEG scan coder and decoder, the host
render filters).

Built at first use with the system C compiler into build/libjxl_tpu_torch/
at the repository root, under a name that carries a hash of the sources,
the flags and the machine, written under a temporary name and moved into
place, so concurrent processes may build at once. When the build fails,
get_lib() returns None and the callers take their pure-Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess
import threading

import numpy as np

_NATIVE = pathlib.Path(__file__).resolve().parent / "native"
_SRCS = tuple(_NATIVE / name for name in (
    "modular_decode.c", "ans_write.c", "vardct_decode.c", "vardct_encode.c",
    "lz77_match.c", "jpegli_scan.c", "jpeg_scan_decode.c",
    "render_filters.c"))
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "build" \
    / "libjxl_tpu_torch"
CC_FLAGS = ("-O3", "-march=native", "-fno-math-errno",
            # no FMA contraction: float kernels must round exactly like
            # the NumPy mul-then-add they mirror (strip-vs-whole decode
            # paths assert bit-equality)
            "-ffp-contract=off", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> pathlib.Path:
    """The host library's path: -march=native ties it to this machine."""
    h = hashlib.sha256(" ".join((*CC_FLAGS, platform.machine(),
                                 platform.node())).encode())
    for src in _SRCS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libjxl_host_{h.hexdigest()[:16]}.so"


def _build(so: pathlib.Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    try:
        subprocess.run(["cc", *CC_FLAGS, *map(str, _SRCS), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def get_lib():
    """The native host library, or None when it cannot be built."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        _lib = _bind(lib)
    return _lib


def _bind(lib):
    lib.decode_channel_nowp.restype = ctypes.c_int
    try:
        lib.ans_write_tokens.restype = ctypes.c_int
        lib.decode_ac_group.restype = ctypes.c_int
        lib.decode_ac_image.restype = ctypes.c_int
        lib.decode_ac_image_sub.restype = ctypes.c_int
        lib.place_ac_metadata.restype = ctypes.c_int
        lib.decode_channel_wp.restype = ctypes.c_int
        lib.ans_read_uints.restype = ctypes.c_int
        lib.ans_read_permutations.restype = ctypes.c_int
        lib.tokenize_ac_image.restype = ctypes.c_int
        lib.hybrid_tokenize.restype = ctypes.c_int
    except AttributeError:
        pass
    c_int, u16p = ctypes.c_int, ctypes.POINTER(ctypes.c_uint16)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    for name, args in (
            ("inverse_mtf", (ctypes.POINTER(ctypes.c_uint32), c_int)),
            ("adaptive_dc_smoothing", (f64p, c_int, c_int, f64p, f64p)),
            ("init_alias_tables", (i32p, i32p, c_int, c_int, c_int, u16p,
                                   ctypes.POINTER(c_int))),
            ("decode_ans_histograms", (
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint64), c_int, c_int, u16p,
                i32p))):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, c_int
    return lib


def _u16(a):
    return np.ascontiguousarray(a, dtype=np.uint16)


class NativeCodes:
    """Preprocessed ANS tables for the C decoder; built once per stream."""

    def __init__(self, code, context_map):
        from .entropy.alias import stacked_alias_fields

        (self.cutoff, self.right, self.freq0, self.offsets1,
         self.freq1) = stacked_alias_fields(code.alias_tables,
                                            code.log_alpha_size)
        self.log_alpha_size = code.log_alpha_size
        self.context_map = np.ascontiguousarray(context_map, dtype=np.uint8)
        self.cfg_split = np.array(
            [c.split_exponent for c in code.uint_config], dtype=np.uint32)
        self.cfg_msb = np.array(
            [c.msb_in_token for c in code.uint_config], dtype=np.uint32)
        self.cfg_lsb = np.array(
            [c.lsb_in_token for c in code.uint_config], dtype=np.uint32)


class NativeTree:
    def __init__(self, tree):
        n = len(tree)
        self.property = np.array([t.property for t in tree], dtype=np.int32)
        self.splitval = np.array([t.splitval for t in tree], dtype=np.int32)
        self.lchild = np.array([t.lchild for t in tree], dtype=np.int32)
        self.rchild = np.array([t.rchild for t in tree], dtype=np.int32)
        self.predictor = np.array([t.predictor for t in tree], dtype=np.int32)
        self.offset = np.array([t.predictor_offset for t in tree],
                               dtype=np.int64)
        self.multiplier = np.array([t.multiplier for t in tree],
                                   dtype=np.int32)


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def hybrid_tokenize_native(lib, ctx: np.ndarray, val: np.ndarray,
                           split_exponent: int, msb: int, lsb: int,
                           counts: np.ndarray, max_tok: int):
    """One-pass hybrid-uint split + histogram accumulation (C).

    ctx: i32[n] contiguous, val: i64[n] contiguous; counts: u32 array of
    num_ctx*max_tok accumulated IN PLACE. Returns (tok u16, nbits u8,
    bits u32) or None when a token overflows the alphabet (caller uses
    the Python path)."""
    n = len(val)
    tok = np.empty(n, dtype=np.uint16)
    nbits = np.empty(n, dtype=np.uint8)
    bits = np.empty(n, dtype=np.uint32)
    is_u32 = val.dtype == np.uint32
    rc = lib.hybrid_tokenize(
        _ptr(ctx, ctypes.c_int32),
        val.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(n), ctypes.c_int(split_exponent),
        ctypes.c_int(msb), ctypes.c_int(lsb),
        _ptr(tok, ctypes.c_uint16), _ptr(nbits, ctypes.c_uint8),
        _ptr(bits, ctypes.c_uint32), _ptr(counts, ctypes.c_uint32),
        ctypes.c_int(max_tok), ctypes.c_int(1 if is_u32 else 0),
        ctypes.c_int(len(counts) // max_tok))
    if rc != 0:
        return None
    return tok, nbits, bits


def ans_write_native(lib, histo: np.ndarray, tok: np.ndarray,
                     nbits: np.ndarray, bits: np.ndarray,
                     freqs: np.ndarray, offs: np.ndarray, rev: np.ndarray,
                     alpha_max: int, init_state: int):
    """C rANS writer. Returns (final_state, out_bytes, total_bits)."""
    n = len(histo)
    out_cap = 6 * n + 16
    out = np.zeros(out_cap, dtype=np.uint8)
    total = ctypes.c_uint64(0)
    st = ctypes.c_uint32(0)
    rc = lib.ans_write_tokens(
        _ptr(np.ascontiguousarray(histo, dtype=np.uint16), ctypes.c_uint16),
        _ptr(np.ascontiguousarray(tok, dtype=np.uint16), ctypes.c_uint16),
        _ptr(np.ascontiguousarray(nbits, dtype=np.uint8), ctypes.c_uint8),
        _ptr(np.ascontiguousarray(bits, dtype=np.uint32), ctypes.c_uint32),
        ctypes.c_size_t(n),
        _ptr(np.ascontiguousarray(freqs, dtype=np.uint16), ctypes.c_uint16),
        _ptr(np.ascontiguousarray(offs, dtype=np.uint32), ctypes.c_uint32),
        _ptr(np.ascontiguousarray(rev, dtype=np.uint16), ctypes.c_uint16),
        ctypes.c_int(alpha_max), ctypes.c_uint32(init_state),
        _ptr(out, ctypes.c_uint8), ctypes.c_size_t(out_cap),
        ctypes.byref(total), ctypes.byref(st))
    if rc != 0:
        raise RuntimeError(f"native ans write failed (rc={rc})")
    nbytes = (total.value + 7) // 8
    return st.value, bytes(out[:nbytes]), total.value


def decode_channel_wp_native(lib, data: bytes, bitpos: int, state: int,
                             ncodes: NativeCodes, ntree: NativeTree,
                             wp_header, chan: int, group_id: int,
                             w: int, h: int):
    """Weighted-predictor channel decode (native/modular_decode.c).
    Returns (out int32 (h, w), new_bitpos, new_state)."""
    out = np.zeros((h, w), dtype=np.int32)
    bp = ctypes.c_uint64(bitpos)
    st = ctypes.c_uint32(state)
    dview = np.frombuffer(data, dtype=np.uint8)
    params = np.array([wp_header.p1c, wp_header.p2c, wp_header.p3ca,
                       wp_header.p3cb, wp_header.p3cc, wp_header.p3cd,
                       wp_header.p3ce, *wp_header.w], dtype=np.int32)
    rc = lib.decode_channel_wp(
        _ptr(dview, ctypes.c_uint8), ctypes.c_size_t(len(data)),
        ctypes.byref(bp), ctypes.byref(st),
        _ptr(ncodes.cutoff, ctypes.c_uint16),
        _ptr(ncodes.right, ctypes.c_uint16),
        _ptr(ncodes.freq0, ctypes.c_uint16),
        _ptr(ncodes.offsets1, ctypes.c_uint16),
        _ptr(ncodes.freq1, ctypes.c_uint16),
        ctypes.c_int(ncodes.log_alpha_size),
        _ptr(ncodes.context_map, ctypes.c_uint8),
        _ptr(ncodes.cfg_split, ctypes.c_uint32),
        _ptr(ncodes.cfg_msb, ctypes.c_uint32),
        _ptr(ncodes.cfg_lsb, ctypes.c_uint32),
        _ptr(ntree.property, ctypes.c_int32),
        _ptr(ntree.splitval, ctypes.c_int32),
        _ptr(ntree.lchild, ctypes.c_int32),
        _ptr(ntree.rchild, ctypes.c_int32),
        _ptr(ntree.predictor, ctypes.c_int32),
        _ptr(ntree.offset, ctypes.c_int64),
        _ptr(ntree.multiplier, ctypes.c_int32),
        _ptr(params, ctypes.c_int32),
        ctypes.c_int(chan), ctypes.c_int(group_id),
        ctypes.c_int(w), ctypes.c_int(h),
        _ptr(out, ctypes.c_int32))
    if rc != 0:
        from .base.status import JXLError

        raise JXLError(f"native WP decode failed (rc={rc})")
    return out, bp.value, st.value


def place_ac_metadata_native(lib, acs_row, qf_row, count, sharp,
                             x0, y0, rw, rh, nbx, nby, gdim_blocks,
                             quant_max, strategy, origin, qf, sharp_out):
    """C AC-metadata placement; returns blocks consumed (-1 = corrupt).
    gdim_blocks bounds every transform to its AC group (dec_modular.cc
    'Invalid AC strategy' overflow checks)."""
    from .vardct import ac_strategy as acs

    assert strategy.dtype == np.int32 and qf.dtype == np.int32
    assert origin.dtype == np.bool_ and sharp_out.dtype == np.int32
    cov_x = np.asarray(acs.COVERED_X, dtype=np.int32)
    cov_y = np.asarray(acs.COVERED_Y, dtype=np.int32)
    return lib.place_ac_metadata(
        _ptr(np.ascontiguousarray(acs_row, dtype=np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(qf_row, dtype=np.int32), ctypes.c_int32),
        ctypes.c_int32(count),
        _ptr(np.ascontiguousarray(sharp, dtype=np.int32), ctypes.c_int32),
        ctypes.c_int(x0), ctypes.c_int(y0), ctypes.c_int(rw),
        ctypes.c_int(rh), ctypes.c_int(nbx), ctypes.c_int(nby),
        ctypes.c_int(gdim_blocks),
        _ptr(cov_x, ctypes.c_int32), _ptr(cov_y, ctypes.c_int32),
        ctypes.c_int(quant_max),
        _ptr(strategy, ctypes.c_int32),
        origin.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _ptr(qf, ctypes.c_int32),
        _ptr(sharp_out, ctypes.c_int32))


def decode_ac_image_native(lib, data: bytes, group_off, group_size,
                           xsize_groups, group_dim_blocks, ncodes,
                           state_maps, luts, histo_bits, num_histograms,
                           num_ac_ctx, num_ctxs, shift, planes,
                           n_threads=1):
    """Whole-image AC decode (native/vardct_decode.c decode_ac_image).
    planes: 3 contiguous int32 (H, W) arrays; n_threads > 1 decodes AC
    groups on a pthread pool (dec_frame.cc:716 RunOnPool analog).
    Returns 0 or error code."""
    dview = np.frombuffer(data, dtype=np.uint8)
    strategy, origin, qf = state_maps
    (bctx_lut, qf_thr, ord_img_off, ord_img_flat,
     cov_x, cov_y, log2cb, ord_lut) = luts
    nby, nbx = strategy.shape
    return lib.decode_ac_image(
        _ptr(dview, ctypes.c_uint8), ctypes.c_size_t(len(data)),
        _ptr(group_off, ctypes.c_uint64), _ptr(group_size, ctypes.c_uint64),
        ctypes.c_int(len(group_off)), ctypes.c_int(xsize_groups),
        ctypes.c_int(group_dim_blocks),
        _ptr(ncodes.cutoff, ctypes.c_uint16),
        _ptr(ncodes.right, ctypes.c_uint16),
        _ptr(ncodes.freq0, ctypes.c_uint16),
        _ptr(ncodes.offsets1, ctypes.c_uint16),
        _ptr(ncodes.freq1, ctypes.c_uint16),
        ctypes.c_int(ncodes.log_alpha_size),
        _ptr(ncodes.context_map, ctypes.c_uint8),
        _ptr(ncodes.cfg_split, ctypes.c_uint32),
        _ptr(ncodes.cfg_msb, ctypes.c_uint32),
        _ptr(ncodes.cfg_lsb, ctypes.c_uint32),
        _ptr(strategy, ctypes.c_int32),
        origin.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _ptr(qf, ctypes.c_int32),
        ctypes.c_int(nby), ctypes.c_int(nbx),
        _ptr(bctx_lut, ctypes.c_int32),
        _ptr(qf_thr, ctypes.c_int64), ctypes.c_int(len(qf_thr)),
        _ptr(ord_img_off, ctypes.c_int64),
        _ptr(ord_img_flat, ctypes.c_int32),
        _ptr(cov_x, ctypes.c_int32), _ptr(cov_y, ctypes.c_int32),
        _ptr(log2cb, ctypes.c_int32), _ptr(ord_lut, ctypes.c_int32),
        ctypes.c_int(histo_bits), ctypes.c_int(num_histograms),
        ctypes.c_int(ncodes.cutoff.shape[0]),  # true table count
        ctypes.c_int(num_ac_ctx),
        ctypes.c_int(num_ctxs), ctypes.c_int(shift),
        ctypes.c_int(planes[0].shape[1]),
        _ptr(planes[0], ctypes.c_int32), _ptr(planes[1], ctypes.c_int32),
        _ptr(planes[2], ctypes.c_int32), ctypes.c_int(n_threads))


def decode_ac_image_sub_native(lib, data: bytes, group_off, group_size,
                               xsize_groups, group_dim_blocks, ncodes, qf,
                               luts, num_ctxs, shifts, planes,
                               n_threads=1, dc_idx=None):
    """Whole-image AC decode of a chroma-subsampled frame
    (native/vardct_decode.c decode_ac_image_sub): every block a DCT8, one
    histogram set, channel c's coefficients into planes[c], a contiguous
    int32 array of that channel's block grid x 8. qf: the luma-grid
    quant field; luts: (bctx_lut, qf_thr, ord_img_off, ord_img_flat,
    ord_lut), the order LUTs mapped to each channel's plane width, the
    block-context LUT with its DC contexts last; shifts: (hs, vs) per
    channel; dc_idx: each luma block's DC context (u8, the quant field's
    shape), None with one DC context. Returns 0 or an error code."""
    dview = np.frombuffer(data, dtype=np.uint8)
    bctx_lut, qf_thr, ord_img_off, ord_img_flat, ord_lut = luts
    nby, nbx = qf.shape
    chan = np.array([s[0] for s in shifts] + [s[1] for s in shifts]
                    + [p.shape[1] for p in planes], dtype=np.int32)
    ndc = 1 if dc_idx is None else bctx_lut.shape[-1]
    dc_ptr = None if dc_idx is None else _ptr(dc_idx, ctypes.c_uint8)
    return lib.decode_ac_image_sub(
        _ptr(dview, ctypes.c_uint8), ctypes.c_size_t(len(data)),
        _ptr(group_off, ctypes.c_uint64), _ptr(group_size, ctypes.c_uint64),
        ctypes.c_int(len(group_off)), ctypes.c_int(xsize_groups),
        ctypes.c_int(group_dim_blocks),
        _ptr(ncodes.cutoff, ctypes.c_uint16),
        _ptr(ncodes.right, ctypes.c_uint16),
        _ptr(ncodes.freq0, ctypes.c_uint16),
        _ptr(ncodes.offsets1, ctypes.c_uint16),
        _ptr(ncodes.freq1, ctypes.c_uint16),
        ctypes.c_int(ncodes.log_alpha_size),
        _ptr(ncodes.context_map, ctypes.c_uint8),
        _ptr(ncodes.cfg_split, ctypes.c_uint32),
        _ptr(ncodes.cfg_msb, ctypes.c_uint32),
        _ptr(ncodes.cfg_lsb, ctypes.c_uint32),
        _ptr(qf, ctypes.c_int32), ctypes.c_int(nby), ctypes.c_int(nbx),
        _ptr(bctx_lut, ctypes.c_int32),
        _ptr(qf_thr, ctypes.c_int64), ctypes.c_int(len(qf_thr)),
        dc_ptr, ctypes.c_int(ndc),
        _ptr(ord_img_off, ctypes.c_int64),
        _ptr(ord_img_flat, ctypes.c_int32), _ptr(ord_lut, ctypes.c_int32),
        ctypes.c_int(ncodes.cutoff.shape[0]),  # true table count
        ctypes.c_int(num_ctxs), _ptr(chan, ctypes.c_int32),
        _ptr(planes[0], ctypes.c_int32), _ptr(planes[1], ctypes.c_int32),
        _ptr(planes[2], ctypes.c_int32), ctypes.c_int(n_threads))


def tokenize_ac_image_native(lib, xsize_groups, ysize_groups,
                             group_dim_blocks, state_maps, luts,
                             num_ctxs, planes, n_threads=1):
    """Whole-image AC tokenization (native/vardct_encode.c): returns a
    list of (ctx i32[n], u i64[n]) per AC group. state_maps/luts use the
    same layout as decode_ac_image_native."""
    strategy, origin, qf = state_maps
    (bctx_lut, qf_thr, ord_img_off, ord_img_flat,
     cov_x, cov_y, log2cb, ord_lut) = luts
    nby, nbx = strategy.shape
    n_groups = xsize_groups * ysize_groups
    gblocks = group_dim_blocks * group_dim_blocks
    # worst case per group: 3 channels x (1 nzeros token + every non-LLF
    # coefficient) = 3 * 64 * blocks tokens (LLF slots buy the headroom)
    group_cap = 3 * 64 * gblocks
    out_ctx = np.empty(n_groups * group_cap, dtype=np.int32)
    out_u = np.empty(n_groups * group_cap, dtype=np.uint32)
    group_len = np.zeros(n_groups, dtype=np.int64)
    rc = lib.tokenize_ac_image(
        ctypes.c_int(xsize_groups), ctypes.c_int(ysize_groups),
        ctypes.c_int(group_dim_blocks),
        _ptr(strategy, ctypes.c_int32),
        origin.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _ptr(qf, ctypes.c_int32),
        ctypes.c_int(nby), ctypes.c_int(nbx),
        _ptr(bctx_lut, ctypes.c_int32),
        _ptr(qf_thr, ctypes.c_int64), ctypes.c_int(len(qf_thr)),
        _ptr(ord_img_off, ctypes.c_int64),
        _ptr(ord_img_flat, ctypes.c_int32),
        _ptr(cov_x, ctypes.c_int32), _ptr(cov_y, ctypes.c_int32),
        _ptr(log2cb, ctypes.c_int32), _ptr(ord_lut, ctypes.c_int32),
        ctypes.c_int(num_ctxs), ctypes.c_int(planes[0].shape[1]),
        _ptr(planes[0], ctypes.c_int32), _ptr(planes[1], ctypes.c_int32),
        _ptr(planes[2], ctypes.c_int32),
        _ptr(out_ctx, ctypes.c_int32),
        _ptr(out_u, ctypes.c_uint32),
        ctypes.c_int64(group_cap),
        _ptr(group_len, ctypes.c_int64), ctypes.c_int(n_threads))
    if rc != 0:
        from .base.status import JXLError

        raise JXLError(f"native AC tokenization failed (rc={rc})")
    out = []
    for g in range(n_groups):
        n = int(group_len[g])
        base = g * group_cap
        # uint32 views, no copy: TokenArray and both tokenization paths
        # accept u32 directly
        out.append((out_ctx[base:base + n], out_u[base:base + n]))
    return out


def decode_ac_group_native(lib, data: bytes, bitpos: int, state: int,
                           ncodes: NativeCodes, blocks: dict,
                           bw: int, bh: int, ctx_offset: int, shift: int,
                           num_ctxs: int, out_flat: np.ndarray):
    """C AC-group decode (native/vardct_decode.c). `blocks` carries the
    per-block arrays prepared by the caller; coefficients accumulate into
    out_flat (int32). Returns (new_bitpos, new_state)."""
    bp = ctypes.c_uint64(bitpos)
    st = ctypes.c_uint32(state)
    dview = np.frombuffer(data, dtype=np.uint8)
    nz = np.zeros(3 * bh * bw, dtype=np.int32)
    rc = lib.decode_ac_group(
        _ptr(dview, ctypes.c_uint8), ctypes.c_size_t(len(data)),
        ctypes.byref(bp), ctypes.byref(st),
        _ptr(ncodes.cutoff, ctypes.c_uint16),
        _ptr(ncodes.right, ctypes.c_uint16),
        _ptr(ncodes.freq0, ctypes.c_uint16),
        _ptr(ncodes.offsets1, ctypes.c_uint16),
        _ptr(ncodes.freq1, ctypes.c_uint16),
        ctypes.c_int(ncodes.log_alpha_size),
        _ptr(ncodes.context_map, ctypes.c_uint8),
        _ptr(ncodes.cfg_split, ctypes.c_uint32),
        _ptr(ncodes.cfg_msb, ctypes.c_uint32),
        _ptr(ncodes.cfg_lsb, ctypes.c_uint32),
        ctypes.c_int(len(blocks["bx"])),
        _ptr(blocks["bx"], ctypes.c_int32),
        _ptr(blocks["by"], ctypes.c_int32),
        _ptr(blocks["cx"], ctypes.c_int32),
        _ptr(blocks["cy"], ctypes.c_int32),
        _ptr(blocks["log2cb"], ctypes.c_int32),
        _ptr(blocks["size"], ctypes.c_int32),
        _ptr(blocks["bctx"], ctypes.c_int32),
        _ptr(blocks["order_off"], ctypes.c_int64),
        _ptr(blocks["orders_flat"], ctypes.c_int32),
        _ptr(blocks["out_off"], ctypes.c_int64),
        ctypes.c_int(bw), ctypes.c_int(bh),
        ctypes.c_int(ctx_offset), ctypes.c_int(shift),
        ctypes.c_int(num_ctxs),
        _ptr(nz, ctypes.c_int32),
        _ptr(out_flat, ctypes.c_int32))
    if rc != 0:
        from .base.status import JXLError

        raise JXLError(f"invalid AC stream (native rc={rc})")
    return bp.value, st.value


def decode_channel_native(lib, data: bytes, bitpos: int, state: int,
                          ncodes: NativeCodes, ntree: NativeTree,
                          chan: int, group_id: int, w: int, h: int):
    """Returns (out int32 (h, w), new_bitpos, new_state)."""
    out = np.zeros((h, w), dtype=np.int32)
    bp = ctypes.c_uint64(bitpos)
    st = ctypes.c_uint32(state)
    buf = ctypes.create_string_buffer(data, len(data))
    rc = lib.decode_channel_nowp(
        ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_size_t(len(data)),
        ctypes.byref(bp), ctypes.byref(st),
        _ptr(ncodes.cutoff, ctypes.c_uint16),
        _ptr(ncodes.right, ctypes.c_uint16),
        _ptr(ncodes.freq0, ctypes.c_uint16),
        _ptr(ncodes.offsets1, ctypes.c_uint16),
        _ptr(ncodes.freq1, ctypes.c_uint16),
        ctypes.c_int(ncodes.log_alpha_size),
        _ptr(ncodes.context_map, ctypes.c_uint8),
        _ptr(ncodes.cfg_split, ctypes.c_uint32),
        _ptr(ncodes.cfg_msb, ctypes.c_uint32),
        _ptr(ncodes.cfg_lsb, ctypes.c_uint32),
        _ptr(ntree.property, ctypes.c_int32),
        _ptr(ntree.splitval, ctypes.c_int32),
        _ptr(ntree.lchild, ctypes.c_int32),
        _ptr(ntree.rchild, ctypes.c_int32),
        _ptr(ntree.predictor, ctypes.c_int32),
        _ptr(ntree.offset, ctypes.c_int64),
        _ptr(ntree.multiplier, ctypes.c_int32),
        ctypes.c_int(chan), ctypes.c_int(group_id),
        ctypes.c_int(w), ctypes.c_int(h),
        _ptr(out, ctypes.c_int32))
    if rc != 0:
        from .base.status import JXLError

        raise JXLError(f"native modular decode failed (rc={rc})")
    return out, bp.value, st.value


def _codes_args(ncodes):
    return (_ptr(ncodes.cutoff, ctypes.c_uint16),
            _ptr(ncodes.right, ctypes.c_uint16),
            _ptr(ncodes.freq0, ctypes.c_uint16),
            _ptr(ncodes.offsets1, ctypes.c_uint16),
            _ptr(ncodes.freq1, ctypes.c_uint16),
            ctypes.c_int(ncodes.log_alpha_size),
            _ptr(ncodes.context_map, ctypes.c_uint8),
            _ptr(ncodes.cfg_split, ctypes.c_uint32),
            _ptr(ncodes.cfg_msb, ctypes.c_uint32),
            _ptr(ncodes.cfg_lsb, ctypes.c_uint32))


def ans_read_uints_native(lib, data: bytes, bitpos: int, state: int,
                          ncodes, n: int, ctx: int):
    """Bulk fixed-context hybrid-uint reads (DecodeContextMap hot loop).
    Returns (values u32[n], new_bitpos, new_state)."""
    bp = ctypes.c_uint64(bitpos)
    st = ctypes.c_uint32(state)
    dview = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros(n, dtype=np.uint32)
    rc = lib.ans_read_uints(
        _ptr(dview, ctypes.c_uint8), ctypes.c_size_t(len(data)),
        ctypes.byref(bp), ctypes.byref(st), *_codes_args(ncodes),
        ctypes.c_int(n), ctypes.c_int(ctx), _ptr(out, ctypes.c_uint32))
    if rc != 0:
        from .base.status import JXLError

        raise JXLError(f"invalid uint stream (native rc={rc})")
    return out, bp.value, st.value


def inverse_mtf_native(lib, values: np.ndarray) -> None:
    """InverseMoveToFrontTransform over u32 values < 256, in place."""
    rc = lib.inverse_mtf(_ptr(values, ctypes.c_uint32),
                         ctypes.c_int(len(values)))
    if rc != 0:
        from .base.status import JXLError

        raise JXLError("invalid MTF index")


# decode_ans_histograms' and init_alias_tables' error codes
_HISTOGRAM_ERRORS = (
    None, "corrupt simple histogram", "invalid shift value",
    "invalid histogram", "invalid histogram count",
    "alphabet size too large", "distribution too long for alias table",
    "distribution sum mismatch", "alias table invariant violated",
    "alias table too large")


def _histogram_error(rc: int):
    from .base.status import JXLError

    return JXLError(_HISTOGRAM_ERRORS[rc])


def decode_ans_histograms_native(lib, r, n: int, log_alpha_size: int):
    """The ANS branch of decode_histograms in one C call: n histograms
    read from the BitReader r (ReadHistogram), each made an alias table
    (InitAliasTable). Returns (tables, degenerate): tables is (5, n,
    1 << log_alpha_size) uint16, the cutoff, right_value, freq0, offsets1
    and freq1 rows of every table; degenerate the histograms' single
    symbols (-1 where none), a list. r is moved past the set."""
    tables = np.empty((5, n, 1 << log_alpha_size), dtype=np.uint16)
    degenerate = np.empty(n, dtype=np.int32)
    bp = ctypes.c_uint64(r.total_bits_consumed())
    dview = np.frombuffer(r.data, dtype=np.uint8)
    rc = lib.decode_ans_histograms(
        _ptr(dview, ctypes.c_uint8), ctypes.c_size_t(len(dview)),
        ctypes.byref(bp), ctypes.c_int(n), ctypes.c_int(log_alpha_size),
        _ptr(tables, ctypes.c_uint16), _ptr(degenerate, ctypes.c_int32))
    if rc != 0:
        raise _histogram_error(rc)
    r.seek_bits(bp.value)
    return tables, degenerate.tolist()


def init_alias_tables_native(lib, dists, log_alpha_size: int) -> np.ndarray:
    """init_alias_table of each distribution (sequences of counts) by the
    C code decode_ans_histograms uses: (5, n, 1 << log_alpha_size)
    uint16, decode_ans_histograms_native's layout."""
    n = len(dists)
    lens = np.array([len(d) for d in dists], dtype=np.int32)
    width = max(int(lens.max(initial=0)), 1)
    buf = np.zeros((n, width), dtype=np.int32)
    for k, d in enumerate(dists):
        buf[k, :len(d)] = d
    out = np.empty((5, n, 1 << log_alpha_size), dtype=np.uint16)
    err = ctypes.c_int(0)
    if lib.init_alias_tables(
            _ptr(buf, ctypes.c_int32), _ptr(lens, ctypes.c_int32),
            ctypes.c_int(width), ctypes.c_int(n),
            ctypes.c_int(log_alpha_size), _ptr(out, ctypes.c_uint16),
            ctypes.byref(err)):
        raise _histogram_error(err.value)
    return out


def adaptive_dc_smoothing_native(lib, dc: np.ndarray, dc_factors):
    """vardct/frame.py adaptive_dc_smoothing's body in one C pass over a
    (3, h, w) float64 DC, h, w > 2: a new array, equal bit for bit."""
    dc = np.ascontiguousarray(dc, dtype=np.float64)
    fac = np.ascontiguousarray(dc_factors, dtype=np.float64)
    if dc.ndim != 3 or dc.shape[0] != 3 or min(dc.shape[1:]) <= 2 \
            or fac.shape != (3,):
        raise ValueError(f"adaptive DC smoothing of {dc.shape} by "
                         f"{fac.shape} factors")
    out = np.empty_like(dc)
    _, h, w = dc.shape
    if lib.adaptive_dc_smoothing(
            _ptr(dc, ctypes.c_double), ctypes.c_int(h), ctypes.c_int(w),
            _ptr(fac, ctypes.c_double), _ptr(out, ctypes.c_double)):
        raise MemoryError("adaptive DC smoothing: no scratch row")
    return out


def ans_read_permutations_native(lib, data: bytes, bitpos: int, state: int,
                                 ncodes, skip_sizes):
    """ReadPermutation + Lehmer decode in C (coeff_order.cc:34-60) of each
    (skip, size) in turn, in one call. Returns (the permutations, i32
    arrays; new_bitpos, new_state)."""
    skips, sizes = (np.array(v, dtype=np.uint32)
                    for v in zip(*skip_sizes))
    bp = ctypes.c_uint64(bitpos)
    st = ctypes.c_uint32(state)
    dview = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros(int(sizes.sum()), dtype=np.int32)
    rc = lib.ans_read_permutations(
        _ptr(dview, ctypes.c_uint8), ctypes.c_size_t(len(data)),
        ctypes.byref(bp), ctypes.byref(st), *_codes_args(ncodes),
        ctypes.c_int(len(sizes)), _ptr(skips, ctypes.c_uint32),
        _ptr(sizes, ctypes.c_uint32), _ptr(out, ctypes.c_int32))
    if rc != 0:
        from .base.status import JXLError

        raise JXLError(f"invalid permutation stream (native rc={rc})")
    return np.split(out, np.cumsum(sizes[:-1])), bp.value, st.value


def epf_pass_native(lib, xyb, inv_sigma_px, sad_mul, channel_scale,
                    pairs, use_plus: bool, sigma_scale: float,
                    min_sigma: float, n_threads: int = 0):
    """One EPF pass in C (native/render_filters.c). xyb: (3, H, W)
    float32 C-contiguous; pairs: [(dy, dx)] symmetric neighbor pairs.
    Row bands run on a thread pool (n_threads=0 -> cpu count; bands are
    independent, results identical at any thread count). Returns the
    filtered (3, H, W) float32 array, or None to fall back."""
    if lib is None or not hasattr(lib, "epf_pass_f32"):
        return None
    h, w = xyb.shape[-2:]
    if h < 5 or w < 5:
        return None
    if n_threads <= 0:
        import os

        n_threads = os.cpu_count() or 1
    xyb = np.ascontiguousarray(xyb, dtype=np.float32)
    out = np.empty_like(xyb)
    inv_sigma_px = np.ascontiguousarray(inv_sigma_px, dtype=np.float32)
    sad_mul = np.ascontiguousarray(sad_mul, dtype=np.float32)
    cs = np.asarray(channel_scale, dtype=np.float32)
    dys = np.array([p[0] for p in pairs], dtype=np.int32)
    dxs = np.array([p[1] for p in pairs], dtype=np.int32)
    rc = lib.epf_pass_f32(
        _ptr(xyb, ctypes.c_float), _ptr(out, ctypes.c_float),
        ctypes.c_int64(h), ctypes.c_int64(w),
        _ptr(inv_sigma_px, ctypes.c_float), _ptr(sad_mul, ctypes.c_float),
        _ptr(cs, ctypes.c_float), _ptr(dys, ctypes.c_int32),
        _ptr(dxs, ctypes.c_int32), ctypes.c_int(len(pairs)),
        ctypes.c_int(1 if use_plus else 0),
        ctypes.c_float(sigma_scale * 1.65), ctypes.c_float(min_sigma),
        ctypes.c_int(n_threads))
    if rc != 0:
        return None
    return out


def conv3x3_sym_native(lib, img, kern):
    """3x3 symmetric-padded convolution in C. img: (H, W) float32."""
    if lib is None or not hasattr(lib, "conv3x3_sym_f32"):
        return None
    h, w = img.shape
    if h < 1 or w < 2:
        return None
    img = np.ascontiguousarray(img, dtype=np.float32)
    out = np.empty_like(img)
    k = np.ascontiguousarray(kern, dtype=np.float32).reshape(-1)
    rc = lib.conv3x3_sym_f32(
        _ptr(img, ctypes.c_float), _ptr(out, ctypes.c_float),
        ctypes.c_int64(h), ctypes.c_int64(w), _ptr(k, ctypes.c_float))
    if rc != 0:
        return None
    return out


_SRGB_U8_TABLES = None


def srgb_u8_native(lib, lin32, thresholds):
    """Fused sRGB transfer + u8 quantization (render_filters.c): lower
    bound of each linear value in the 255 decision thresholds via a
    4096-bucket hint table + one fixup compare."""
    global _SRGB_U8_TABLES
    if lib is None or not hasattr(lib, "srgb_u8_f32"):
        return None
    if _SRGB_U8_TABLES is None:
        thr = np.empty(256, dtype=np.float32)
        thr[:255] = thresholds
        thr[255] = np.inf  # sentinel for the fixup read at hint == 255
        edges = (np.arange(4096, dtype=np.float32)
                 / np.float32(4096.0)).astype(np.float32)
        hint = np.searchsorted(thresholds, edges,
                               side="left").astype(np.uint8)
        _SRGB_U8_TABLES = (thr, hint)
    thr, hint = _SRGB_U8_TABLES
    flat = lin32.ravel()
    if not flat.flags.c_contiguous:
        flat = np.ascontiguousarray(flat)
    out = np.empty(flat.shape[0], dtype=np.uint8)
    lib.srgb_u8_f32(_ptr(flat, ctypes.c_float), _ptr(out, ctypes.c_uint8),
                    ctypes.c_int64(flat.shape[0]),
                    _ptr(thr, ctypes.c_float), _ptr(hint, ctypes.c_uint8))
    return out.reshape(lin32.shape)


def dequant_dct8_native(lib, qimg, ys, xs, qf, dm, inv_gs, x_dm_mult,
                        b_dm_mult, x_cc, b_cc, dc, biases):
    """Fused DCT8 dequant (render_filters.c): gather + AdjustQuantBias
    + dequant matrices + CfL + DC overwrite in one C sweep. Returns
    float32 (n, 3, 64) wide-layout coefficients or None to fall back."""
    if lib is None or not hasattr(lib, "dequant_dct8_f32"):
        return None
    n = len(ys)
    _, H, W = qimg.shape
    nby, nbx = qf.shape
    qimg = np.ascontiguousarray(qimg, dtype=np.int32)
    ys = np.ascontiguousarray(ys, dtype=np.int64)
    xs = np.ascontiguousarray(xs, dtype=np.int64)
    qf = np.ascontiguousarray(qf, dtype=np.int32)
    dm = np.ascontiguousarray(dm, dtype=np.float32).reshape(3, 64)
    x_cc = np.ascontiguousarray(x_cc, dtype=np.float32)
    b_cc = np.ascontiguousarray(b_cc, dtype=np.float32)
    dc = np.ascontiguousarray(dc, dtype=np.float32)
    bias = np.ascontiguousarray(biases, dtype=np.float32)
    out = np.empty((n, 3, 64), dtype=np.float32)
    lib.dequant_dct8_f32(
        _ptr(qimg, ctypes.c_int32), ctypes.c_int64(H), ctypes.c_int64(W),
        _ptr(ys, ctypes.c_int64), _ptr(xs, ctypes.c_int64),
        ctypes.c_int64(n), _ptr(qf, ctypes.c_int32),
        ctypes.c_int64(nby), ctypes.c_int64(nbx),
        _ptr(dm, ctypes.c_float), ctypes.c_float(inv_gs),
        ctypes.c_float(x_dm_mult), ctypes.c_float(b_dm_mult),
        _ptr(x_cc, ctypes.c_float), _ptr(b_cc, ctypes.c_float),
        _ptr(dc, ctypes.c_float), _ptr(bias, ctypes.c_float),
        _ptr(out, ctypes.c_float))
    return out


def hybrid_tokenize_mixed_native(lib, ctx, val, lz, cfg, lcfg,
                                 min_symbol, counts, max_tok):
    """Mixed literal/LZ77-length tokenization + histogram in one C pass
    (ans_write.c hybrid_tokenize_mixed). Returns (tok, nbits, bits) or
    None to fall back (token overflow / bad context)."""
    if lib is None or not hasattr(lib, "hybrid_tokenize_mixed"):
        return None
    n = len(val)
    val = np.ascontiguousarray(val, dtype=np.int64)
    lzm = np.ascontiguousarray(lz, dtype=np.uint8)
    tok = np.empty(n, dtype=np.uint16)
    nbits = np.empty(n, dtype=np.uint8)
    bits = np.empty(n, dtype=np.uint32)
    rc = lib.hybrid_tokenize_mixed(
        _ptr(ctx, ctypes.c_int32), _ptr(val, ctypes.c_int64),
        _ptr(lzm, ctypes.c_uint8), ctypes.c_size_t(n),
        ctypes.c_int(cfg.split_exponent), ctypes.c_int(cfg.msb_in_token),
        ctypes.c_int(cfg.lsb_in_token),
        ctypes.c_int(lcfg.split_exponent), ctypes.c_int(lcfg.msb_in_token),
        ctypes.c_int(lcfg.lsb_in_token), ctypes.c_int(min_symbol),
        _ptr(tok, ctypes.c_uint16), _ptr(nbits, ctypes.c_uint8),
        _ptr(bits, ctypes.c_uint32), _ptr(counts, ctypes.c_uint32),
        ctypes.c_int(max_tok), ctypes.c_int(len(counts) // max_tok))
    if rc != 0:
        return None
    return tok, nbits, bits


def jpegli_scan_native(lib, comps, enc_tables, mcux: int, mcuy: int,
                       restart_interval: int):
    """Baseline interleaved scan emission in C (native/jpegli_scan.c).

    comps: sequence of objects with .coeffs (nby, nbx, 64) int32
    zigzag, .h_samp/.v_samp and .dc_table/.ac_table ids; enc_tables:
    dict (table_class, table_id) -> {symbol: (length, code)}.
    Returns scan bytes (stuffed, 1-padded) or None when the native
    library is unavailable.
    """
    if lib is None:
        return None
    slots = sorted(enc_tables)
    ntab = len(slots)
    depths = np.zeros((ntab, 256), dtype=np.uint8)
    codes = np.zeros((ntab, 256), dtype=np.uint16)
    slot_idx = {}
    for i, key in enumerate(slots):
        slot_idx[key] = i
        for sym, (ln, code) in enc_tables[key].items():
            depths[i, sym] = ln
            codes[i, sym] = code
    ncomp = len(comps)
    blobs = []
    offs = np.zeros(ncomp, dtype=np.int64)
    nbxs = np.zeros(ncomp, dtype=np.int32)
    vss = np.zeros(ncomp, dtype=np.int32)
    hss = np.zeros(ncomp, dtype=np.int32)
    dcs = np.zeros(ncomp, dtype=np.int32)
    acs = np.zeros(ncomp, dtype=np.int32)
    total = 0
    for i, c in enumerate(comps):
        arr = np.ascontiguousarray(c.coeffs.reshape(-1, 64),
                                   dtype=np.int32)
        blobs.append(arr)
        offs[i] = total
        total += arr.shape[0]
        nbxs[i] = c.coeffs.shape[1]
        vss[i] = c.v_samp
        hss[i] = c.h_samp
        dcs[i] = slot_idx[(0, c.dc_table)]
        acs[i] = slot_idx[(1, c.ac_table)]
    coeffs = np.concatenate(blobs) if blobs else \
        np.zeros((0, 64), dtype=np.int32)
    cap = total * 300 + 4096 + (total // max(restart_interval, 1)) * 2 \
        if restart_interval else total * 300 + 4096
    out = np.zeros(cap, dtype=np.uint8)
    lib.jpegli_encode_scan.restype = ctypes.c_int64
    n = lib.jpegli_encode_scan(
        _ptr(coeffs, ctypes.c_int32), _ptr(offs, ctypes.c_int64),
        _ptr(nbxs, ctypes.c_int32), _ptr(vss, ctypes.c_int32),
        _ptr(hss, ctypes.c_int32), _ptr(dcs, ctypes.c_int32),
        _ptr(acs, ctypes.c_int32), ctypes.c_int(ncomp),
        ctypes.c_int(mcux), ctypes.c_int(mcuy),
        ctypes.c_int(restart_interval),
        _ptr(depths, ctypes.c_uint8), _ptr(codes, ctypes.c_uint16),
        _ptr(out, ctypes.c_uint8), ctypes.c_int64(cap))
    if n < 0:
        return None
    return out[:n].tobytes()


def jpeg_decode_scan_native(lib, data: bytes, start: int, comps,
                            dec_specs, huffman, mcux: int, mcuy: int,
                            restart_interval: int):
    """Baseline sequential scan decode in C (native/jpeg_scan_decode.c).

    comps: scan components (jpeg.data.Component) in scan order;
    dec_specs: per component (grp_v, grp_h) block counts per MCU;
    huffman: list of jpeg.data.HuffmanTable.  Returns (new_pos,
    per_comp_coeffs int16 list, rst_pads list[str], final_pad str,
    extra_zero_runs list[(idx, n)]) or None to fall back to Python.
    """
    if lib is None:
        return None
    ntab = len(huffman)
    if ntab == 0 or ntab > 16 or len(comps) > 8:
        return None
    counts = np.zeros((ntab, 16), dtype=np.uint8)
    values = np.zeros((ntab, 256), dtype=np.uint8)
    nvals = np.zeros(ntab, dtype=np.int32)
    slot = {}
    for i, t in enumerate(huffman):
        # later DHTs with the same id replace earlier ones (slot reuse)
        slot[(t.table_class, t.table_id)] = i
        counts[i] = t.counts
        n = min(len(t.values), 256)
        values[i, :n] = t.values[:n]
        nvals[i] = n
    ncomp = len(comps)
    offs = np.zeros(ncomp, dtype=np.int64)
    nbxs = np.zeros(ncomp, dtype=np.int32)
    gvs = np.zeros(ncomp, dtype=np.int32)
    ghs = np.zeros(ncomp, dtype=np.int32)
    dcs = np.zeros(ncomp, dtype=np.int32)
    acs = np.zeros(ncomp, dtype=np.int32)
    total = 0
    for i, (c, (gv, gh)) in enumerate(zip(comps, dec_specs)):
        key_dc = (0, c.dc_table)
        key_ac = (1, c.ac_table)
        if key_dc not in slot or key_ac not in slot:
            return None
        offs[i] = total
        total += c.coeffs.shape[0] * c.coeffs.shape[1]
        nbxs[i] = c.coeffs.shape[1]
        gvs[i] = gv
        ghs[i] = gh
        dcs[i] = slot[key_dc]
        acs[i] = slot[key_ac]
    buf = np.zeros(total * 64, dtype=np.int16)
    dview = np.frombuffer(data, dtype=np.uint8)
    n_restarts_max = (mcux * mcuy) // restart_interval + 2 \
        if restart_interval else 2
    rst_len = np.zeros(n_restarts_max, dtype=np.uint8)
    rst_bits = np.zeros(n_restarts_max, dtype=np.uint8)
    n_rst = ctypes.c_int64(0)
    fin_len = ctypes.c_int32(0)
    fin_bits = ctypes.c_int32(0)
    ezr_cap = 65536
    ezr_idx = np.zeros(ezr_cap, dtype=np.int64)
    ezr_n = np.zeros(ezr_cap, dtype=np.int32)
    n_ezr = ctypes.c_int64(0)
    lib.jpeg_decode_baseline_scan.restype = ctypes.c_int64
    rc = lib.jpeg_decode_baseline_scan(
        _ptr(dview, ctypes.c_uint8), ctypes.c_int64(len(data)),
        ctypes.c_int64(start), _ptr(buf, ctypes.c_int16),
        _ptr(offs, ctypes.c_int64), _ptr(nbxs, ctypes.c_int32),
        _ptr(gvs, ctypes.c_int32), _ptr(ghs, ctypes.c_int32),
        _ptr(dcs, ctypes.c_int32), _ptr(acs, ctypes.c_int32),
        ctypes.c_int(ncomp), ctypes.c_int(mcux), ctypes.c_int(mcuy),
        ctypes.c_int(restart_interval),
        _ptr(counts, ctypes.c_uint8), _ptr(values, ctypes.c_uint8),
        _ptr(nvals, ctypes.c_int32), ctypes.c_int(ntab),
        _ptr(rst_len, ctypes.c_uint8), _ptr(rst_bits, ctypes.c_uint8),
        ctypes.c_int64(n_restarts_max), ctypes.byref(n_rst),
        ctypes.byref(fin_len), ctypes.byref(fin_bits),
        _ptr(ezr_idx, ctypes.c_int64), _ptr(ezr_n, ctypes.c_int32),
        ctypes.c_int64(ezr_cap), ctypes.byref(n_ezr))
    if rc == -3:
        return None
    if rc < 0:
        from .base.status import JXLError

        raise JXLError("invalid JPEG scan (native)")
    per_comp = []
    for i, c in enumerate(comps):
        nb = c.coeffs.shape[0] * c.coeffs.shape[1]
        per_comp.append(
            buf[offs[i] * 64:(offs[i] + nb) * 64]
            .reshape(c.coeffs.shape))
    pads = [format(int(rst_bits[i]), f"0{int(rst_len[i])}b")
            if rst_len[i] else ""
            for i in range(int(n_rst.value))]
    fin = format(fin_bits.value, f"0{fin_len.value}b") \
        if fin_len.value else ""
    ezr = [(int(ezr_idx[i]), int(ezr_n[i]))
           for i in range(int(n_ezr.value))]
    return int(rc), per_comp, pads, fin, ezr
