"""TPU-resident rANS entropy decode of VarDCT AC coefficient streams.

The reference decodes AC groups with a per-thread scalar loop
(lib/jxl/dec_group.cc:453-530 DecodeACVarBlock inside a RunOnPool); its
~400 MP/s design point assumes a many-core CPU. This rig has ONE host
core, so the entropy decode itself moves onto the TPU: every AC group's
rANS stream is an independent lane, and one Pallas kernel decodes one
symbol per lane per step across (R, 128) lanes — the whole batch's
groups in lockstep. This is a TPU-first redesign, not a port: there is
no reference analog (libjxl has no GPU/accelerator entropy path).

Design (fixed by microbenchmarks on TPU v5e):
- Per-lane table lookups use the two Mosaic-supported vector gathers:
  `take_along_axis(axis=1)` (128-entry lane gather) composed over table
  rows, and 8-deep sublane selects. Shared tables (alias entries,
  context map) are packed into (rows, 128) u32 planes.
- Per-lane PRIVATE data (the bit stream) cannot be gathered, so each
  lane gets a 256-halfword window re-gathered from HBM by plain XLA
  between supersteps; inside the kernel the window is consumed strictly
  sequentially through a 32x8 bank ladder + 48-bit bit-buffer.
- A superstep is F symbol steps, F sized so the worst-case bit
  consumption (16-bit renorm + max hybrid-uint raw bits, computed
  exactly per stream from its tables) cannot overrun the window: lanes
  never stall, so the output tape stays dense.
- The kernel emits one i32 per lane per step into a dense tape:
  bit 30 marks a chain start (the nzeros token), else the coefficient
  token value. Phase 2 (pure XLA) turns the tape into dense coefficient
  planes: marker-rank cumsum -> per-chain start step via batched
  binary search -> one big gather + per-block coefficient-order
  permutation. No scatter anywhere (XLA:TPU scatter serializes).

Scope (host fallback otherwise, reported loudly by the caller):
single pass, rANS (no LZ77/prefix), num_histograms == 1,
num_dc_ctxs == 1, alphabet < 64, n_clusters << log_alpha_size <= 2048,
context map <= 8192 entries. All 27 strategies decode; phase-2
placement currently covers DCT8-only images (the serving path).
"""

from __future__ import annotations

import functools

import numpy as np

from ..entropy.alias import stacked_alias_fields

ANS_LOG = 12
ANS_SIGNATURE = 0x13 << 16
MARKER = 1 << 30          # tape flag: chain-start (nzeros) step
TAPE_VAL = MARKER - 1     # value mask in a tape word
WIN_HW = 256              # stream window halfwords per lane (512 B)
META_WIN = 256            # chain-meta window entries per lane
NONZERO_BUCKETS = 37
ZD_COUNT = 458

# ac_context.h:24-45 (format constants; also in native/vardct_decode.c)
K_FREQ_CTX = np.array([
    0xBAD, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
    27, 27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30],
    dtype=np.int32)
K_NONZ_CTX = np.array([
    0xBAD, 0, 31, 62, 62, 93, 93, 93, 93, 123, 123, 123, 123,
    152, 152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180,
    180, 180, 180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206],
    dtype=np.int32)


class AnsTpuUnsupported(Exception):
    """Stream shape outside the device kernel's scope (host fallback)."""


# --------------------------------------------------------------------------
# Host plan builder
# --------------------------------------------------------------------------

class DecodePlan:
    """Device-ready arrays for one batch of frames (one pass each)."""
    __slots__ = (
        "n_lanes", "R", "F", "n_supersteps_hint", "max_steps",
        "streams_hw", "stream_nhw", "meta", "n_chains", "max_chains",
        "cm_packed", "alias_w1", "alias_w2", "las", "cm_rows",
        "alias_rows", "num_ctxs", "max_bits_per_sym",
        "lane_img", "lane_gy", "lane_gx", "states", "chain_block",
        "chain_ci", "chain_sizes", "imgs_geom", "orders",
        "alias_w1_list", "alias_w2_list", "cm_list", "num_ctxs_list",
    )


def _pack_alias_tables(code, context_map):
    """Alias entries + hybrid-uint config packed into 2 u32 words:
    w1 = cutoff(8) | right(6)<<8 | freq0(13)<<14 | split(3)<<27 |
         msb(2)<<30 ; w2 = freq1(13) | offsets1(12)<<13 | lsb(2)<<25.
    (cutoff <= bucket size = 1 << (12 - las), so 8 bits covers las >= 4.)
    Indexed by (cluster << las) | bucket."""
    tables = code.alias_tables
    n = len(tables)
    las = code.log_alpha_size
    size = 1 << las
    if n * size > 2048:
        raise AnsTpuUnsupported(
            f"alias table too large for kernel ({n}x{size})")
    max_nbits = 0
    w1 = w2 = np.zeros(0, np.int64)
    if n:
        cutoff, right, freq0, off1, freq1 = stacked_alias_fields(
            tables, las).astype(np.int64)
        cfgs = code.uint_config[:n]
        se, msb, lsb = (np.array([getattr(c, a) for c in cfgs], np.int64)
                        for a in ("split_exponent", "msb_in_token",
                                  "lsb_in_token"))
        # the first table out of scope raises its first failure
        big = right.max(axis=1) >= 64
        wide = (se > 7) | (msb > 3) | (lsb > 3)
        bad = big | wide | (las < 4)
        if bad.any():
            i = int(np.argmax(bad))
            raise AnsTpuUnsupported(
                "alphabet >= 64" if big[i] else
                "hybrid-uint config out of range" if wide[i] else
                "log_alpha_size < 4 (cutoff > 255)")
        # exact max raw-bit count for any token a table can emit: the
        # count grows with the token, so each table's largest decides
        split = 1 << se
        ml = msb + lsb
        tok = np.maximum(right.max(axis=1), min(size, 64) - 1)
        nb = se - ml + ((tok - split) >> ml)
        max_nbits = int(nb[tok >= split].max(initial=0))
        w1 = (cutoff | (right << 8) | (freq0 << 14) | (se << 27)[:, None]
              | (msb << 30)[:, None]).reshape(-1)
        w2 = (freq1 | (off1 << 13) | (lsb << 25)[:, None]).reshape(-1)
    pad = -(n * size) % 128
    w1 = np.concatenate([w1, np.zeros(pad, np.int64)])
    w2 = np.concatenate([w2, np.zeros(pad, np.int64)])
    return (w1.astype(np.uint32).astype(np.int64).astype(np.uint32),
            w2.astype(np.uint32), las, max_nbits)


def check_context_map(cmap):
    """cmap as u8 entries; raises outside the kernel's scope."""
    cm = np.asarray(cmap, np.uint8)
    if len(cm) > 8192:
        raise AnsTpuUnsupported(f"context map too large ({len(cm)})")
    if cm.max(initial=0) >= 64:
        raise AnsTpuUnsupported("cluster id >= 64")
    return cm


def _pack_context_map(cmap):
    """Context map u8 entries packed 4-per-u32, (rows, 128)."""
    cm = check_context_map(cmap)
    n_words = (len(cm) + 3) // 4
    rows = max(1, -(-n_words // 128))
    buf = np.zeros(rows * 128 * 4, dtype=np.uint8)
    buf[:len(cm)] = cm
    return buf.view("<u4").astype(np.uint32).reshape(rows, 128), rows


def check_streams(states):
    """The batch's AC streams against the kernel's scope (single pass,
    rANS, one histogram set, no DC-conditioned block contexts); raises
    AnsTpuUnsupported with the first failure, in build_plan's order."""
    st0 = states[0]
    code = st0.ac_code[0]
    if code.lz77.enabled or code.use_prefix_code:
        raise AnsTpuUnsupported("lz77/prefix AC stream")
    if st0.block_ctx_map.num_dc_ctxs != 1:
        raise AnsTpuUnsupported("dc-conditioned block contexts")
    for st in states:
        if st.num_histograms != 1:
            raise AnsTpuUnsupported("multiple histogram sets")
        if st.fh.passes.num_passes != 1:
            raise AnsTpuUnsupported("progressive passes")
        if st.block_ctx_map.num_dc_ctxs != 1:
            raise AnsTpuUnsupported("dc-conditioned block contexts")
        c = st.ac_code[0]
        if c.lz77.enabled or c.use_prefix_code:
            raise AnsTpuUnsupported("lz77/prefix AC stream")


def pack_tables(states):
    """Each image's alias tables packed (_pack_alias_tables). Returns
    (packed, las, max_nbits): the per-image (w1, w2, las, max_nbits), the
    batch's log alpha size and its largest raw-bit count of a token."""
    packed = [_pack_alias_tables(st.ac_code[0], st.ac_context_map[0])
              for st in states]
    las = packed[0][2]
    if any(p[2] != las for p in packed):
        raise AnsTpuUnsupported("mixed log_alpha_size in batch")
    return packed, las, max(p[3] for p in packed)


def per_image_alias(packed):
    """pack_tables' words as i32 (rows, 128) tables, every image's padded
    to the batch's largest row count, so that per-image row strides
    match. Returns (w1 list, w2 list, rows)."""
    max_rows = max(len(p[0]) // 128 for p in packed)
    w1l, w2l = [], []
    for p in packed:
        w1 = p[0].view(np.int32).reshape(-1, 128)
        w2 = p[1].view(np.int32).reshape(-1, 128)
        if w1.shape[0] < max_rows:
            pad = np.zeros((max_rows - w1.shape[0], 128), np.int32)
            w1 = np.concatenate([w1, pad])
            w2 = np.concatenate([w2, pad])
        w1l.append(w1)
        w2l.append(w2)
    return w1l, w2l, max_rows


def build_plan(states, datas, raw_list, shared_tables=True):
    """states: VarDCTState list (headers+DC+meta decoded, AC captured raw);
    datas: frame section bytes per state; raw_list: (offs, sizes) of the
    single pass's AC group sections per state. Raises AnsTpuUnsupported
    for streams outside kernel scope.

    shared_tables=True requires identical entropy tables across the
    batch (single packed table set); False keeps per-image table sets
    (plan.alias_w1_list/... + per-lane bases) — the Pallas kernel packs
    those per sublane (ans_kernel.build_serve_plan).

    This is the oracle route: the DecodePlan carries each chain's
    metadata for simulate and place_numpy, and ans_kernel.build_lane_plan
    lays it out for the kernel. The card's route (tpu_codec.
    prepare_batch_entropy) builds its LanePlan straight from the sections
    (ans_kernel.lane_plan_from_sections), sharing check_streams,
    pack_tables, per_image_alias and check_context_map with this one."""
    check_streams(states)
    plan = DecodePlan()
    packed, las, max_nbits = pack_tables(states)
    if shared_tables:
        w1, w2 = packed[0][0], packed[0][1]
        cm0 = states[0].ac_context_map[0]
        for si, st in enumerate(states[1:], 1):
            if len(packed[si][0]) != len(w1) \
                    or not np.array_equal(packed[si][0], w1) \
                    or not np.array_equal(packed[si][1], w2) \
                    or not np.array_equal(
                        np.asarray(st.ac_context_map[0]),
                        np.asarray(cm0)):
                raise AnsTpuUnsupported("mixed entropy tables in batch")
        cm_packed, cm_rows = _pack_context_map(cm0)
        plan.cm_packed, plan.cm_rows = cm_packed, cm_rows
        plan.alias_w1 = w1.view(np.int32).reshape(-1, 128)
        plan.alias_w2 = w2.view(np.int32).reshape(-1, 128)
        plan.alias_rows = plan.alias_w1.shape[0]
        plan.alias_w1_list = [plan.alias_w1] * len(states)
        plan.alias_w2_list = [plan.alias_w2] * len(states)
        plan.cm_list = [np.asarray(states[0].ac_context_map[0], np.uint8)
                        ] * len(states)
    else:
        w1l, w2l, max_rows = per_image_alias(packed)
        plan.alias_w1_list, plan.alias_w2_list = w1l, w2l
        plan.alias_w1, plan.alias_w2 = w1l[0], w2l[0]
        plan.alias_rows = max_rows
        plan.cm_list = [np.asarray(st.ac_context_map[0], np.uint8)
                        for st in states]
        cm_packed, cm_rows = _pack_context_map(plan.cm_list[0])
        plan.cm_packed, plan.cm_rows = cm_packed, cm_rows
    plan.las = las
    plan.num_ctxs = states[0].block_ctx_map.num_ctxs
    plan.num_ctxs_list = [st.block_ctx_map.num_ctxs for st in states]
    plan.max_bits_per_sym = 16 + max_nbits
    plan.states = states
    plan.orders = [st.orders[0] if st.orders else {} for st in states]

    # ---- lanes: one per AC group, batch-major then raster group order
    lane_streams = []
    lane_img, lane_gy, lane_gx = [], [], []
    chain_meta, chain_block, chain_ci, chain_sizes = [], [], [], []
    n_chains = []
    from .ans_tpu_meta import lane_chain_meta  # split for clarity

    for si, (st, data, (offs, sizes)) in enumerate(
            zip(states, datas, raw_list)):
        fd = st.fd
        bctx_lut = _bctx_lut_np(st)
        for g in range(fd.num_groups):
            gx, gy = g % fd.xsize_groups, g // fd.xsize_groups
            lane_img.append(si)
            lane_gy.append(gy)
            lane_gx.append(gx)
            sec = data[offs[g]:offs[g] + sizes[g]]
            lane_streams.append(np.frombuffer(
                sec + b"\x00" * (-len(sec) % 2), dtype="<u2"))
            meta, blocks, cis, sz = lane_chain_meta(st, gx, gy, bctx_lut)
            chain_meta.append(meta)
            chain_block.append(blocks)
            chain_ci.append(cis)
            chain_sizes.append(sz)
            n_chains.append(len(meta))

    L = len(lane_streams)
    R = 8 * max(1, -(-L // 1024))
    n_lanes_pad = R * 128
    plan.n_lanes, plan.R = L, R
    max_hw = max((len(s) for s in lane_streams), default=1)
    # window gathers read up to WIN_HW past the live pointer
    streams_hw = np.zeros((n_lanes_pad, max_hw + WIN_HW), dtype=np.uint16)
    for i, s in enumerate(lane_streams):
        streams_hw[i, :len(s)] = s
    plan.streams_hw = streams_hw.astype(np.int32)  # device-friendly
    plan.stream_nhw = np.array(
        [len(s) for s in lane_streams] + [0] * (n_lanes_pad - L),
        dtype=np.int32)

    max_chains = max(n_chains, default=1)
    meta_arr = np.zeros((n_lanes_pad, max_chains + META_WIN),
                        dtype=np.int32)
    for i, m in enumerate(chain_meta):
        meta_arr[i, :len(m)] = m
    plan.meta = meta_arr
    plan.n_chains = np.array(n_chains + [0] * (n_lanes_pad - L),
                             dtype=np.int32)
    plan.max_chains = max_chains
    plan.chain_block = chain_block
    plan.chain_ci = chain_ci
    plan.chain_sizes = chain_sizes
    plan.lane_img = np.array(lane_img, dtype=np.int32)
    plan.lane_gy = np.array(lane_gy, dtype=np.int32)
    plan.lane_gx = np.array(lane_gx, dtype=np.int32)

    plan.F = max(8, (WIN_HW - 8) * 16 // plan.max_bits_per_sym)
    # worst-case total steps (structural bound; used for continuation)
    worst = 0
    for i in range(L):
        worst = max(worst, int(np.sum(chain_sizes[i]))
                    + len(chain_sizes[i]))
    plan.max_steps = worst
    plan.n_supersteps_hint = -(-worst // plan.F)
    plan.imgs_geom = [(st.fd.ysize_blocks, st.fd.xsize_blocks)
                      for st in states]
    return plan


def _bctx_lut_np(state):
    """(3, NUM_ORDERS, nqf+1) block-context LUT (as frame._bctx_luts)."""
    from ..vardct import ac_strategy as acs

    bcm = state.block_ctx_map
    nqf = len(bcm.qf_thresholds)
    cmap_arr = np.asarray(bcm.ctx_map, np.int32)
    lut = np.empty((3, acs.NUM_ORDERS, nqf + 1), dtype=np.int32)
    for cidx in range(3):
        for o in range(acs.NUM_ORDERS):
            for qi in range(nqf + 1):
                lut[cidx, o, qi] = cmap_arr[
                    ((cidx * acs.NUM_ORDERS + o) * (nqf + 1) + qi)
                    * bcm.num_dc_ctxs]
    return lut, np.asarray(bcm.qf_thresholds, dtype=np.int64)


# --------------------------------------------------------------------------
# Lockstep NumPy simulator (exactness oracle for the Pallas kernel)
# --------------------------------------------------------------------------

def simulate(plan, max_supersteps=None, trace_lane=None, trace_out=None):
    """Run the lockstep decode in NumPy. Returns (tape i32[T, n_lanes],
    steps_done, ok_flags). Mirrors the kernel op-for-op: same masks,
    same windowing, same i32 wrap semantics."""
    L = plan.n_lanes
    F = plan.F
    streams = plan.streams_hw[:L].astype(np.uint32)
    meta = plan.meta[:L]
    n_chains = plan.n_chains[:L].astype(np.int64)

    # lane registers
    st = np.zeros(L, np.uint32)
    h = np.zeros((3, L), np.uint32)          # 48-bit bit-buffer halves
    cnt = np.zeros(L, np.int64)
    awp = np.zeros(L, np.int64)              # absolute halfword pointer
    chain = np.zeros(L, np.int64)            # chain ordinal
    mode = np.zeros(L, np.int64)             # 0 = expect nzeros
    k = np.zeros(L, np.int64)
    remaining = np.zeros(L, np.int64)
    prev = np.zeros(L, np.int64)
    corrupt = np.zeros(L, bool)
    done = n_chains == 0
    # current chain meta (unpacked registers)
    bc = np.zeros(L, np.int64)
    l2 = np.zeros(L, np.int64)
    size = np.zeros(L, np.int64)
    cb = np.zeros(L, np.int64)
    bx = np.zeros(L, np.int64)
    by0 = np.zeros(L, np.int64)
    bcx = np.zeros(L, np.int64)
    # per-channel nz row buffer: latest nz write per block column
    # (serves both the top and the current-row-left predictor reads;
    # correctness argument in ans_tpu_meta.py docstring)
    row_top = np.zeros((L, 3, 32), np.int64)
    cur_ci = np.zeros(L, np.int64)

    def load_meta(m):
        """Unpack chain meta for lanes in mask m from meta[chain]."""
        mm = meta[np.arange(L)[m], np.minimum(
            chain[m], meta.shape[1] - 1)].astype(np.int64)
        bc[m] = mm & 63
        l2[m] = (mm >> 6) & 15
        cb[m] = 1 << l2[m]
        size[m] = cb[m] * 64
        bx[m] = (mm >> 10) & 31
        by0[m] = (mm >> 15) & 1
        bcx[m] = 1 + ((mm >> 16) & 31)
        cur_ci[m] = (mm >> 21) & 3

    def pull16(m):
        """Refill bit-buffers: lanes in m pull one halfword. Caller
        guarantees cnt[m] <= 31 (slot 0 or 1 only)."""
        hw = streams[np.arange(L)[m], awp[m]].astype(np.uint32)
        slot = (cnt[m] >> 4).astype(np.int64)
        off = (cnt[m] & 15).astype(np.uint32)
        for s in (0, 1):
            sel = slot == s
            if not sel.any():
                continue
            idx = np.arange(L)[m][sel]
            lohw = (hw[sel] << off[sel]) & np.uint32(0xFFFF)
            # off == 0: hw >> 16 == 0 (hw < 2^16)
            hihw = hw[sel] >> (16 - off[sel])
            h[s, idx] |= lohw
            h[s + 1, idx] |= hihw.astype(np.uint32)
        cnt[m] += 16
        awp[m] += 1

    def read_bits(m, n):
        """Read n[m] bits for lanes in m; consumes. Returns values."""
        need = n
        while True:
            pulls = m & (cnt < need)
            if not pulls.any():
                break
            pull16(pulls)
        v = (h[0] | (h[1] << 16)).astype(np.uint64)
        v |= h[2].astype(np.uint64) << 32
        mask = (np.uint64(1) << need.astype(np.uint64)) - np.uint64(1)
        out = (v & mask).astype(np.uint32)
        vs = v >> need.astype(np.uint64)
        h[0][m] = (vs[m] & np.uint64(0xFFFF)).astype(np.uint32)
        h[1][m] = ((vs[m] >> np.uint64(16)) & np.uint64(0xFFFF)).astype(
            np.uint32)
        h[2][m] = ((vs[m] >> np.uint64(32)) & np.uint64(0xFFFF)).astype(
            np.uint32)
        cnt[m] -= need[m]
        out[~m] = 0
        return out.astype(np.int64)

    # init: 32-bit state per live lane
    live = ~done
    load_meta(live)
    n32 = np.full(L, 32, np.int64)
    init = read_bits(live, n32)
    st[live] = init[live].astype(np.uint32)

    # stacked per-image tables + per-lane base offsets (identical
    # pointers when shared_tables packed one set)
    lane_imgv = plan.lane_img[:L].astype(np.int64)
    cm_offs = np.zeros(len(plan.cm_list) + 1, np.int64)
    cm_offs[1:] = np.cumsum([len(c) for c in plan.cm_list])
    cm_all = np.concatenate([np.asarray(c, np.int64)
                             for c in plan.cm_list])
    cm_base = cm_offs[lane_imgv]
    a_stride = plan.alias_rows * 128
    a1 = np.concatenate([w.view(np.uint32).reshape(-1).astype(np.int64)
                         for w in plan.alias_w1_list])
    a2 = np.concatenate([w.view(np.uint32).reshape(-1).astype(np.int64)
                         for w in plan.alias_w2_list])
    a_base = lane_imgv * a_stride
    las = plan.las
    les = ANS_LOG - las
    num_ctxs = np.asarray(plan.num_ctxs_list, np.int64)[lane_imgv]
    zd_base = num_ctxs * NONZERO_BUCKETS

    T = (max_supersteps or plan.n_supersteps_hint + 2) * F
    tape = np.zeros((T, L), np.int32)
    t_done = T

    for t in range(T):
        act = ~done & ~corrupt
        if not act.any():
            t_done = t
            break
        is_nz = act & (mode == 0)
        in_ch = act & (mode == 1)
        # ---- context
        pred = np.zeros(L, np.int64)
        if is_nz.any():
            top = row_top[np.arange(L), cur_ci, bx]
            left = row_top[np.arange(L), cur_ci, np.maximum(bx - 1, 0)]
            m0 = is_nz & (bx == 0)
            pred[m0] = np.where(by0[m0] == 1, 32, top[m0])
            mx = is_nz & (bx != 0)
            pred[mx] = np.where(by0[mx] == 1, left[mx],
                                (top[mx] + left[mx] + 1) >> 1)
            pred = np.minimum(pred, 64)
        nzb = np.where(pred < 8, pred, 4 + (pred >> 1))
        ctx_nz = nzb * num_ctxs + bc
        nzl = (remaining + cb - 1) >> l2
        zctx = (K_NONZ_CTX[np.minimum(nzl, 63)]
                + K_FREQ_CTX[np.minimum(k >> l2, 63)]) * 2 + prev
        bad_z = in_ch & (zctx >= ZD_COUNT)
        corrupt |= bad_z
        in_ch &= ~bad_z
        act = is_nz | in_ch
        ctx = np.where(is_nz, ctx_nz, zd_base + ZD_COUNT * bc + zctx)
        ctx = np.clip(cm_base + ctx, 0, len(cm_all) - 1)
        cluster = cm_all[ctx]
        if trace_lane is not None and trace_out is not None:
            tl = trace_lane
            trace_out.append(dict(
                t=t, nz=bool(is_nz[tl]), ctx=int(ctx[tl]),
                pred=int(pred[tl]), bc=int(bc[tl]), bx=int(bx[tl]),
                by0=int(by0[tl]), ci=int(cur_ci[tl]),
                chain=int(chain[tl]), st=int(st[tl]),
                cl=int(cluster[tl])))
        # ---- rANS symbol
        res = (st & 0xFFF).astype(np.int64)
        i_b = res >> les
        pos = res & ((1 << les) - 1)
        ai = np.clip(a_base + ((cluster << las) | i_b), 0, len(a1) - 1)
        w1 = a1[ai]
        w2 = a2[ai]
        cutoff = w1 & 255
        right = (w1 >> 8) & 63
        freq0 = (w1 >> 14) & 0x1FFF
        se = (w1 >> 27) & 7
        msb = (w1 >> 30) & 3
        freq1 = w2 & 0x1FFF
        off1 = (w2 >> 13) & 0xFFF
        lsb = (w2 >> 25) & 3
        ge = pos >= cutoff
        sym = np.where(ge, right, i_b)
        off = np.where(ge, off1 + pos, pos)
        freq = np.where(ge, freq1, freq0)
        nst = (freq.astype(np.uint64)
               * (st >> ANS_LOG).astype(np.uint64)
               + off.astype(np.uint64)) & np.uint64(0xFFFFFFFF)
        nst = nst.astype(np.uint32)
        st = np.where(act, nst, st)
        renorm = act & (st < (1 << 16))
        n16 = np.full(L, 16, np.int64)
        b16 = read_bits(renorm, n16)
        st = np.where(renorm, (st << 16) | b16.astype(np.uint32), st)
        # ---- hybrid uint
        split = (1 << se).astype(np.int64)
        small = sym < split
        ml = msb + lsb
        nbits = np.maximum(se - ml + ((sym - split) >> ml), 0)
        nbits = np.where(small, 0, nbits)
        raw_m = act & ~small & (nbits > 0)
        raw = read_bits(raw_m, nbits)
        low = sym & ((1 << lsb) - 1)
        tok2 = sym >> lsb
        val = ((((1 << msb) | (tok2 & ((1 << msb) - 1)))
                << nbits) | raw) << lsb | low
        u = np.where(small, sym, val)
        # ---- dispatch
        tp = np.where(is_nz, MARKER | np.minimum(u, TAPE_VAL),
                      np.minimum(u, TAPE_VAL)).astype(np.int64)
        tape[t] = np.where(act, tp, 0).astype(np.int32)
        # nzeros step
        bad_nz = is_nz & (u > size - cb)
        corrupt |= bad_nz
        is_nz_ok = is_nz & ~bad_nz
        nzv = u
        npb = (nzv + cb - 1) >> l2
        wr = is_nz_ok
        if wr.any():
            for d in range(32):
                mm = wr & (d >= bx) & (d < bx + bcx)
                if mm.any():
                    row_top[np.arange(L)[mm], cur_ci[mm], d] = npb[mm]
        prev = np.where(is_nz_ok, np.where(nzv > (size >> 4), 0, 1), prev)
        remaining = np.where(is_nz_ok, nzv, remaining)
        k = np.where(is_nz_ok, cb, k)
        empty = is_nz_ok & (nzv == 0)
        mode = np.where(is_nz_ok & ~empty, 1, mode)
        # coefficient step
        bad_u = in_ch & (u >= (1 << 27))
        corrupt |= bad_u
        in_ok = in_ch & ~bad_u
        nzflag = (u != 0).astype(np.int64)
        prev = np.where(in_ok, nzflag, prev)
        remaining = np.where(in_ok, remaining - nzflag, remaining)
        k = np.where(in_ok, k + 1, k)
        ch_end = in_ok & (remaining == 0)
        ch_over = in_ok & (k >= size) & (remaining > 0)
        corrupt |= ch_over
        # advance chain
        adv = empty | ch_end
        if adv.any():
            chain[adv] += 1
            mode[adv] = 0
            newly_done = adv & (chain >= n_chains)
            done |= newly_done
            still = adv & ~newly_done
            if still.any():
                load_meta(still)
    else:
        t_done = T

    ok = ~corrupt & done
    # final state check
    ok &= (st == ANS_SIGNATURE) | (n_chains == 0)
    return tape[:t_done], t_done, ok


# --------------------------------------------------------------------------
# Phase 2: tape -> dense coefficient planes (NumPy reference)
# --------------------------------------------------------------------------

def place_numpy(plan, tape):
    """Rebuild qimg planes (per state) from the dense tape. DCT8-general:
    uses per-chain (block, ci, size) lists from the plan. Returns a list
    of i32[3, H, W] qimgs matching decode_ac_bulk_native output."""
    from ..vardct import ac_strategy as acs

    L = plan.n_lanes
    markers = (tape & MARKER) != 0
    out = []
    for si, st in enumerate(plan.states):
        fd = st.fd
        h, w = fd.ysize_blocks * 8, fd.xsize_blocks * 8
        out.append(np.zeros((3, h, w), dtype=np.int32))
    gdim_bl = plan.states[0].fd.group_dim // 8
    for lane in range(L):
        si = plan.lane_img[lane]
        st = plan.states[si]
        fd = st.fd
        w = fd.xsize_blocks * 8
        qimg = out[si]
        starts = np.nonzero(markers[:, lane])[0]
        nc = plan.n_chains[lane]
        assert len(starts) >= nc, f"lane {lane}: {len(starts)} < {nc}"
        starts = starts[:nc]
        ends = np.append(starts[1:], tape.shape[0])
        blocks = plan.chain_block[lane]
        cis = plan.chain_ci[lane]
        by0g = plan.lane_gy[lane] * gdim_bl
        bx0g = plan.lane_gx[lane] * gdim_bl
        pass_orders = plan.orders[si]
        for c_ord in range(nc):
            blk = blocks[c_ord]
            ci = cis[c_ord]
            by, bxl = blk >> 6, blk & 63
            aby, abx = by0g + by, bx0g + bxl
            s = int(st.strategy[aby, abx])
            cx, cy = acs.COVERED_X[s], acs.COVERED_Y[s]
            cb = cx * cy
            cols = cx * 8
            order = pass_orders.get((acs.STRATEGY_ORDER[s], ci))
            if order is None:
                order = acs.natural_coeff_order(s)
            order = np.asarray(order, dtype=np.int64)
            oimg = ((order // cols) * w + order % cols)
            t0, t1 = starts[c_ord], ends[c_ord]
            t1 = min(t1, t0 + 1 + (64 * cb - cb))
            vals = tape[t0 + 1:t1, lane] & TAPE_VAL
            u = vals.astype(np.int64)
            coeff = np.where(u & 1, -((u + 1) >> 1), u >> 1)
            base = aby * 8 * w + abx * 8
            ks = cb + np.arange(len(coeff))
            tgt = base + oimg[ks]
            plane = qimg[ci].reshape(-1)
            plane[tgt] += coeff.astype(np.int32)
    return out
