"""Device rANS decode of DCT8 AC groups and the placement of its tape (the
port of libjxl_tpu/ops/ans_kernel.py).

A LanePlan lays one batch's AC groups out flat, one lane per group, for
one thread per lane: the counterpart of build_serve_plan without the
TPU's (8, 128) sublane packing. Two routes build it. The card's route,
lane_plan_from_sections (tpu_codec.prepare_batch_entropy), builds it
straight from the frames' AC sections. The oracle route, build_lane_plan,
lays out a DecodePlan (ops/ans_tpu.build_plan, the NumPy host layer, or
the JAX package's), whose per-chain metadata the NumPy simulator and
place_numpy read; the tests hold the two routes' plans equal.
ans_decode_plain is the plain torch twin of the CUDA
kernel ops/csrc/ans_decode.cu (TPU kernel K3, _make_kernel): a lockstep
decode over the lanes, one Python iteration per step. place is phase 2
(_placer_fn / place_device): the tape becomes qimg coefficient planes
through cumsum, a search, a gather and the coefficient-order permutation.

The tape holds one i32 word per lane per step: the step's token, with
bit 30 set on a chain start (the nzeros token), and 0 once the lane has
stopped. A lane's chains run over the group's DCT8 blocks in raster
order, channels j = 0, 1, 2 (Y, X, B) inside each block.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..vardct import ac_strategy as acs
from .ans_tpu import (ANS_LOG, ANS_SIGNATURE, K_FREQ_CTX, K_NONZ_CTX, MARKER,
                      NONZERO_BUCKETS, TAPE_VAL, ZD_COUNT, AnsTpuUnsupported,
                      _bctx_lut_np, check_context_map, check_streams,
                      pack_tables, per_image_alias)
from .build import CTA_LANES

MAX_LANES = 1024     # the JAX plan's lane grid, 8 x 128
# the JAX kernel's steps a call (F_TOT): the device-entropy program's tape
# has a multiple of it rows, so that its key takes the JAX form
TAPE_STEP = 120
# the device-entropy program's alias tables have a multiple of it rows
ALIAS_STEP = 8
# the JAX ServePlan's rows of a zero-density LUT (zd_rows)
ZD_ROWS = -(-((3 * ZD_COUNT + 3) // 4) // 128)
SLACK_HW = 256       # zero halfwords after each lane's stream
GROUP_BLOCKS = 32    # DCT8 blocks per group side
NZ_WIDTH = 3 * NONZERO_BUCKETS
ZD_WIDTH = 3 * ZD_COUNT
_M32 = 0xFFFFFFFF
# the planes of a JAX ServePlan's lane_cfg (libjxl_tpu/ops/ans_kernel.py)
C_NCH, C_BW, C_TSLOT = 0, 1, 2


@dataclasses.dataclass(eq=False)
class LanePlan:
    """One batch's AC streams and entropy tables, flat per lane (NumPy)."""

    flat_hw: np.ndarray    # u16 [N]: lanes' halfwords, SLACK_HW zeros after
    lane_off: np.ndarray   # i64 [L]: first halfword of each lane
    n_chains: np.ndarray   # i32 [L]
    bw: np.ndarray         # i32 [L]: block columns of the lane's group
    lane_img: np.ndarray   # i32 [L]
    a1: np.ndarray         # u32 [B, alias_rows * 128]: alias words
    a2: np.ndarray         # u32 [B, alias_rows * 128]
    nzclu: np.ndarray      # u8 [B, 3 * 37]: cluster of (j, nzeros bucket)
    zdclu: np.ndarray      # u8 [B, 3 * 458]: cluster of (j, zero-density ctx)
    kz: np.ndarray         # i32 [128]: K_NONZ_CTX, K_FREQ_CTX; [0], [64] = 0
    inv_order: np.ndarray  # i64 [B, 3, 64]: raster pos -> chain step (0 unset)
    las: int               # log alpha size of the alias tables
    alias_rows: int
    t_alloc: int           # tape rows: the structural bound plan.max_steps
    B: int
    gy: int                # groups per column and per row
    gx: int
    H: int                 # block-padded height and width
    W: int

    @property
    def n_lanes(self) -> int:
        return len(self.lane_off)

    def arrays(self) -> dict:
        """LaneTensors' arrays as numpy, u16 and u32 words viewed as
        int16 and int32, with the CTA table of ans_decode.cu
        (cta_first)."""
        return dict(
            flat_hw=self.flat_hw.view(np.int16), lane_off=self.lane_off,
            n_chains=self.n_chains, bw=self.bw, lane_img=self.lane_img,
            a1=self.a1.view(np.int32), a2=self.a2.view(np.int32),
            nzclu=self.nzclu, zdclu=self.zdclu, kz=self.kz,
            cta_first=cta_first(self.lane_img))

    def to(self, device) -> "LaneTensors":
        """The decode's inputs as tensors on `device`."""
        return LaneTensors(
            **{k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
               for k, a in self.arrays().items()},
            las=self.las, t_alloc=self.t_alloc)


@dataclasses.dataclass(frozen=True, eq=False)
class LaneTensors:
    """LanePlan's decode inputs on one device; u16 and u32 words travel as
    their int16 and int32 bit patterns."""

    flat_hw: torch.Tensor
    lane_off: torch.Tensor
    n_chains: torch.Tensor
    bw: torch.Tensor
    lane_img: torch.Tensor
    a1: torch.Tensor
    a2: torch.Tensor
    nzclu: torch.Tensor
    zdclu: torch.Tensor
    kz: torch.Tensor
    cta_first: torch.Tensor  # i32 [n_cta + 1]: see cta_first()
    las: int
    t_alloc: int


def tape_rows(t_alloc: int) -> int:
    """t_alloc rounded up to a multiple of TAPE_STEP (the JAX ServePlan's
    t_alloc of the same plan)."""
    return -(-t_alloc // TAPE_STEP) * TAPE_STEP


def program_plan(lp: "LanePlan") -> "LanePlan":
    """lp as the device-entropy program takes it, so that batches of one
    geometry and one encoder setting share a program: flat_hw zero-padded
    to a power of two halfwords, the alias tables to a multiple of
    ALIAS_STEP rows (entries past a table's own are never read), the tape
    to tape_rows."""
    flat = np.zeros(1 << (len(lp.flat_hw) - 1).bit_length(), np.uint16)
    flat[:len(lp.flat_hw)] = lp.flat_hw
    rows = -(-lp.alias_rows // ALIAS_STEP) * ALIAS_STEP
    pad = ((0, 0), (0, (rows - lp.alias_rows) * 128))
    return dataclasses.replace(
        lp, flat_hw=flat, a1=np.pad(lp.a1, pad), a2=np.pad(lp.a2, pad),
        alias_rows=rows, t_alloc=tape_rows(lp.t_alloc))


def sublane_images(lane_img: np.ndarray) -> int:
    """The JAX ServePlan's n_per_sub: the most images whose lanes share
    one of its 8 sublanes of 128 lanes (at least 1)."""
    lanes = np.full(MAX_LANES, -1, np.int64)
    lanes[:len(lane_img)] = lane_img
    per_sub = [len({int(v) for v in row if v >= 0})
               for row in lanes.reshape(8, 128)]
    return max(1, max(per_sub))


def program_key(lp: "LanePlan") -> tuple:
    """(alias_rows, zd_rows, las, n_per_sub, max_iters, t_alloc): the JAX
    ServePlan's fields in its _ENTROPY_PROGS key, from the same plan;
    t_alloc is tape_rows of the plan's structural bound. Of a
    program_plan, alias_rows is its rounded count."""
    rows = tape_rows(lp.t_alloc)
    return (lp.alias_rows, ZD_ROWS, lp.las, sublane_images(lp.lane_img),
            rows // TAPE_STEP, rows)


def cta_first(lane_img: np.ndarray) -> np.ndarray:
    """ans_decode.cu's CTAs, in image order: CTA b decodes lanes
    cta_first[b] .. cta_first[b + 1] - 1, at most CTA_LANES (compiled
    into the kernel by ops/build.py) of one image, so that it holds one
    image's tables in shared memory. i32 [n_cta + 1]; lanes are in image
    order (build_lane_plan)."""
    lane_img = np.asarray(lane_img)
    L = len(lane_img)
    starts = np.flatnonzero(np.r_[True, lane_img[1:] != lane_img[:-1]])
    ends = np.r_[starts[1:], L]
    firsts = [np.arange(a, b, CTA_LANES) for a, b in zip(starts, ends)]
    return np.r_[np.concatenate(firsts), L].astype(np.int32)


def _kz_table() -> np.ndarray:
    kz = np.zeros(128, np.int32)
    kz[:64] = K_NONZ_CTX
    kz[64:] = K_FREQ_CTX
    kz[0] = kz[64] = 0      # sentinels, never a live context
    return kz


def _dct8_orders(orders):
    """(3, 64) inverse order of one image's DCT8 coefficient orders (its
    pass's dict): raster pos -> chain step (0 = DC, unset)."""
    inv = np.zeros((3, 64), np.int64)
    for ci in range(3):
        order = orders.get((0, ci))
        if order is None:
            order = acs.natural_coeff_order(0)
        order = np.asarray(order, np.int64)
        for kk in range(1, 64):
            inv[ci, order[kk]] = kk
    return inv


def check_lane_scope(states, max_bits_per_sym: int, n_lanes: int) -> None:
    """The kernel's scope beyond the streams' (ans_tpu.check_streams):
    raises AnsTpuUnsupported with the first failure, with the messages of
    the JAX package's build_serve_plan, and for more than 1024 lanes (16
    frames of 2048 x 2048)."""
    if max_bits_per_sym > 32:
        raise AnsTpuUnsupported("symbol needs > 32 bits")
    for st in states:
        if not (st.strategy == 0).all():
            raise AnsTpuUnsupported("non-DCT8 strategy in frame")
        if len(st.block_ctx_map.qf_thresholds) != 0:
            raise AnsTpuUnsupported("quant-field block contexts")
        fd = st.fd
        if fd.xsize_blocks % (fd.group_dim // 8) or \
                fd.ysize_blocks % (fd.group_dim // 8):
            raise AnsTpuUnsupported("image dims not multiple of group")
        if fd.group_dim != 256:
            raise AnsTpuUnsupported("non-256 group dim")
    fd = states[0].fd
    if any(s.fd.xsize_blocks != fd.xsize_blocks
           or s.fd.ysize_blocks != fd.ysize_blocks for s in states):
        raise AnsTpuUnsupported("mixed geometry batch")
    if n_lanes > MAX_LANES:
        raise AnsTpuUnsupported(f"more than {MAX_LANES} lanes")


def _cluster_luts(states):
    """(nzclu, zdclu): each image's cluster of (j, nzeros bucket) and of
    (j, zero-density context), the block context and num_ctxs folded in
    per j."""
    B = len(states)
    nzclu = np.zeros((B, NZ_WIDTH), np.uint8)
    zdclu = np.zeros((B, ZD_WIDTH), np.uint8)
    for si, st in enumerate(states):
        cm = np.asarray(st.ac_context_map[0], np.int64)
        num_ctxs = st.block_ctx_map.num_ctxs
        bc = _bctx_lut_np(st)[0][:, 0, 0].astype(np.int64)[:, None]
        nzclu[si] = cm[np.arange(NONZERO_BUCKETS) * num_ctxs + bc].reshape(-1)
        zdclu[si] = cm[num_ctxs * NONZERO_BUCKETS + ZD_COUNT * bc
                       + np.arange(ZD_COUNT)].reshape(-1)
    return nzclu, zdclu


def _geometry(states) -> dict:
    fd = states[0].fd
    return dict(B=len(states), gy=fd.ysize_groups, gx=fd.xsize_groups,
                H=fd.ysize_blocks * 8, W=fd.xsize_blocks * 8)


def _alias(words) -> np.ndarray:
    """Per-image i32 (rows, 128) alias tables as u32 [B, rows * 128]."""
    return np.stack(words).view(np.uint32).reshape(len(words), -1)


def build_lane_plan(plan) -> LanePlan:
    """Lay a DecodePlan (built with shared_tables=False) out per lane.

    The oracle route, fed by ans_tpu.build_plan (the port's or the JAX
    package's), whose chain metadata simulate and place_numpy read; the
    card's route builds the same LanePlan without that metadata
    (lane_plan_from_sections). Raises AnsTpuUnsupported outside the
    kernel's scope (check_lane_scope)."""
    states = plan.states
    check_lane_scope(states, plan.max_bits_per_sym, plan.n_lanes)
    L = plan.n_lanes
    nhw = plan.stream_nhw[:L].astype(np.int64)
    ends = np.cumsum(nhw + SLACK_HW)
    lane_off = ends - nhw - SLACK_HW
    flat = np.zeros(int(ends[-1]), np.uint16)
    for i in range(L):
        flat[lane_off[i]:lane_off[i] + nhw[i]] = plan.streams_hw[i, :nhw[i]]
    lane_img = plan.lane_img[:L].astype(np.int32)
    xsize = np.array([s.fd.xsize_blocks for s in states], np.int64)
    bw = np.minimum(xsize[lane_img] - plan.lane_gx[:L] * GROUP_BLOCKS,
                    GROUP_BLOCKS).astype(np.int32)
    nzclu, zdclu = _cluster_luts(states)
    return LanePlan(
        flat_hw=flat, lane_off=lane_off,
        n_chains=plan.n_chains[:L].astype(np.int32), bw=bw,
        lane_img=lane_img, a1=_alias(plan.alias_w1_list),
        a2=_alias(plan.alias_w2_list), nzclu=nzclu, zdclu=zdclu,
        kz=_kz_table(),
        inv_order=np.stack([_dct8_orders(o) for o in plan.orders]),
        las=int(plan.las), alias_rows=int(plan.alias_rows),
        t_alloc=int(plan.max_steps), **_geometry(states))


def lane_plan_from_sections(states, datas, raw_list) -> LanePlan:
    """The card's route: the LanePlan that build_lane_plan(ans_tpu.
    build_plan(states, datas, raw_list, shared_tables=False)) gives, built
    straight from each image's AC group sections, without the DecodePlan's
    per-chain metadata, which the kernel derives itself.

    The scope admits only all-DCT8 frames of whole 256 x 256 groups, so
    every chain takes at most 64 steps (its nzeros token and 63
    coefficients) and the tape's structural bound is 64 x the most chains
    of a lane. Raises AnsTpuUnsupported with the first failure of
    build_plan's checks and then build_lane_plan's, in their order."""
    check_streams(states)
    packed, las, max_nbits = pack_tables(states)
    w1l, w2l, alias_rows = per_image_alias(packed)
    check_context_map(states[0].ac_context_map[0])
    groups = [st.fd.num_groups for st in states]
    check_lane_scope(states, 16 + max_nbits, sum(groups))

    # each lane's halfwords (an odd section takes a zero byte), then
    # SLACK_HW zero halfwords
    buf = bytearray()
    starts, n_chains, bws = [], [], []
    slack = bytes(2 * SLACK_HW + 1)
    for st, data, (offs, sizes) in zip(states, datas, raw_list):
        fd = st.fd
        gdim = fd.group_dim // 8
        view = memoryview(data)
        for g in range(fd.num_groups):
            gx, gy = g % fd.xsize_groups, g // fd.xsize_groups
            sec = view[offs[g]:offs[g] + sizes[g]]
            starts.append(len(buf) // 2)
            buf += sec
            buf += slack[:2 * SLACK_HW + len(sec) % 2]
            bh = min(fd.ysize_blocks - gy * gdim, gdim)
            bw = min(fd.xsize_blocks - gx * gdim, gdim)
            n_chains.append(3 * bh * bw)
            bws.append(bw)
    flat = np.frombuffer(buf, "<u2").astype(np.uint16, copy=False)
    lane_img = np.repeat(np.arange(len(states), dtype=np.int32), groups)
    n_chains = np.array(n_chains, np.int32)
    nzclu, zdclu = _cluster_luts(states)
    return LanePlan(
        flat_hw=flat, lane_off=np.array(starts, np.int64),
        n_chains=n_chains, bw=np.array(bws, np.int32),
        lane_img=lane_img, a1=_alias(w1l), a2=_alias(w2l), nzclu=nzclu,
        zdclu=zdclu, kz=_kz_table(),
        inv_order=np.stack([_dct8_orders(st.orders[0] if st.orders else {})
                            for st in states]),
        las=int(las), alias_rows=int(alias_rows),
        t_alloc=64 * int(n_chains.max()), **_geometry(states))


def lane_plan_from_serve_plan(sp) -> LanePlan:
    """The LanePlan held in a JAX ServePlan (ans_kernel.build_serve_plan):
    its per-sublane table planes unpacked through the lanes' table slots,
    so both packages can be fed the identical state."""
    L = sp.n_lanes
    lane_img = sp.plan.lane_img[:L].astype(np.int32)
    cfg = sp.lane_cfg.reshape(3, -1)
    first = np.array([np.flatnonzero(lane_img == b)[0] for b in range(sp.B)])
    sub, slot = first // 128, cfg[C_TSLOT, first]

    def per_image(planes, rows):
        return np.stack([planes[t * rows:(t + 1) * rows, s]
                         for s, t in zip(sub, slot)])     # [B, rows, 128]

    zd_bytes = per_image(sp.zdclu, sp.zd_rows).astype("<i4").view(np.uint8)
    return LanePlan(
        flat_hw=sp.flat_hw,
        # the JAX lane offsets start past the 2-halfword state preload
        lane_off=sp.lane_off[:L].astype(np.int64) - 2,
        n_chains=cfg[C_NCH, :L].astype(np.int32),
        bw=cfg[C_BW, :L].astype(np.int32), lane_img=lane_img,
        a1=per_image(sp.a1, sp.alias_rows).view(np.uint32).reshape(sp.B, -1),
        a2=per_image(sp.a2, sp.alias_rows).view(np.uint32).reshape(sp.B, -1),
        nzclu=per_image(sp.nzclu, 1)[:, 0, :NZ_WIDTH].astype(np.uint8),
        zdclu=zd_bytes.reshape(sp.B, -1)[:, :ZD_WIDTH],
        kz=sp.kz[0].astype(np.int32), inv_order=sp.inv_order,
        las=int(sp.las), alias_rows=int(sp.alias_rows),
        t_alloc=int(sp.plan.max_steps), B=sp.B, gy=sp.gy, gx=sp.gx, H=sp.H,
        W=sp.W)


def ans_decode_plain(lt: LaneTensors):
    """The plain twin of ops/csrc/ans_decode.cu, vectorised over lanes.

    Returns (tape i32[t_alloc, L], ok bool[L], steps i32[L]): ok means the
    lane finished its chains, met no corrupt token and ended in the rANS
    signature state (or had no chains); steps counts the steps in which
    the lane decoded a symbol. u32 arithmetic runs in i64 masked to 32
    bits."""
    dev = lt.flat_hw.device
    L = lt.lane_off.numel()
    i64 = torch.int64
    flat = lt.flat_hw.to(i64) & 0xFFFF
    last = flat.numel() - 1
    nch = lt.n_chains.to(i64)
    bw = lt.bw.to(i64)
    img = lt.lane_img.to(i64)
    aw = lt.a1.shape[1]
    a1 = lt.a1.to(i64).reshape(-1) & _M32
    a2 = lt.a2.to(i64).reshape(-1) & _M32
    a_base = img * aw
    nzclu = lt.nzclu.to(i64).reshape(-1)
    zdclu = lt.zdclu.to(i64).reshape(-1)
    nz_base = img * NZ_WIDTH
    zd_base = img * ZD_WIDTH
    kz = lt.kz.to(i64)
    las = lt.las
    les = ANS_LOG - las

    def zeros(dtype=i64):
        return torch.zeros(L, dtype=dtype, device=dev)

    def hw(p):
        return flat[p.clamp(max=last)]

    pos = lt.lane_off.to(i64)
    st = hw(pos) | (hw(pos + 1) << 16)
    pos = pos + 2
    buf, cnt = zeros(), zeros()
    rows = torch.zeros((L, 3 * GROUP_BLOCKS), dtype=i64, device=dev)
    mode, k, rem, prev, j, bx, by, chain = (zeros() for _ in range(8))
    done = nch == 0
    corrupt = zeros(torch.bool)
    steps = zeros(torch.int32)
    tape = torch.zeros((lt.t_alloc, L), dtype=torch.int32, device=dev)

    def read(n):
        nonlocal buf, cnt
        out = buf & ((1 << n) - 1)
        buf = buf >> n
        cnt = cnt - n
        return out

    for t in range(lt.t_alloc):
        act = ~done & ~corrupt
        if not bool(act.any()):
            break
        for _ in range(2):      # refill to >= 32 bits
            need = act & (cnt < 32)
            buf = torch.where(need, buf | (hw(pos) << cnt), buf)
            cnt = cnt + need * 16
            pos = pos + need
        is_nz = act & (mode == 0)
        in_ch = act & (mode == 1)

        # nzeros predictor and its cluster
        ridx = j * GROUP_BLOCKS + bx
        top = rows.gather(1, ridx[:, None])[:, 0]
        left = rows.gather(1, (ridx - (bx > 0).to(i64))[:, None])[:, 0]
        pred = torch.where(bx == 0, torch.where(by == 0, 32, top),
                           torch.where(by == 0, left, (top + left + 1) >> 1))
        pred = pred.clamp(max=64)
        nzb = torch.where(pred < 8, pred, 4 + (pred >> 1))
        cl_nz = nzclu[nz_base + j * NONZERO_BUCKETS + nzb]

        # zero-density context
        zctx = (kz[rem.clamp(0, 63)] + kz[64 + k.clamp(0, 63)]) * 2 + prev
        bad_z = in_ch & (zctx >= ZD_COUNT)
        corrupt = corrupt | bad_z
        in_ch = in_ch & ~bad_z
        act = is_nz | in_ch
        steps += act
        zidx = (j * ZD_COUNT + zctx).clamp(0, ZD_WIDTH - 1)
        cluster = torch.where(is_nz, cl_nz, zdclu[zd_base + zidx])

        # rANS symbol through the alias table
        res = st & 0xFFF
        i_b = res >> les
        p = res & ((1 << les) - 1)
        ai = ((cluster << las) | i_b).clamp(0, aw - 1)
        w1 = a1[a_base + ai]
        w2 = a2[a_base + ai]
        ge = p >= (w1 & 255)
        sym = torch.where(ge, (w1 >> 8) & 63, i_b)
        se = (w1 >> 27) & 7
        msb = (w1 >> 30) & 3
        lsb = (w2 >> 25) & 3
        freq = torch.where(ge, w2 & 0x1FFF, (w1 >> 14) & 0x1FFF)
        off = torch.where(ge, ((w2 >> 13) & 0xFFF) + p, p)
        st = torch.where(act, (freq * (st >> ANS_LOG) + off) & _M32, st)
        renorm = act & ((st >> 16) == 0)
        b16 = read(renorm * 16)
        st = torch.where(renorm, ((st << 16) | b16) & _M32, st)

        # hybrid uint
        split = 1 << se
        small = sym < split
        ml = msb + lsb
        nbits = torch.where(small, 0, se - ml + ((sym - split) >> ml))
        nbits = nbits.clamp(min=0)
        raw = read(torch.where(act & ~small, nbits, 0))
        tok2 = sym >> lsb
        val = ((((1 << msb) | (tok2 & ((1 << msb) - 1))) << nbits) | raw) \
            << lsb | (sym & ((1 << lsb) - 1))
        u = torch.where(small, sym, val)
        uv = u.clamp(max=TAPE_VAL)
        tape[t] = torch.where(act, torch.where(is_nz, MARKER | uv, uv),
                              0).to(torch.int32)

        # nzeros token: row file, chain state
        bad_nz = is_nz & (u > 63)
        corrupt = corrupt | bad_nz
        is_ok = is_nz & ~bad_nz
        rows.scatter_(1, ridx[:, None], torch.where(is_ok, u, top)[:, None])
        prev = torch.where(is_ok, (u <= 4).to(i64), prev)
        rem = torch.where(is_ok, u, rem)
        k = torch.where(is_ok, 1, k)
        empty = is_ok & (u == 0)
        mode = torch.where(is_ok & ~empty, 1, mode)

        # coefficient token
        bad_u = in_ch & (u >= (1 << 27))
        corrupt = corrupt | bad_u
        in_ok = in_ch & ~bad_u
        nzf = (in_ok & (u != 0)).to(i64)
        prev = torch.where(in_ok, nzf, prev)
        rem = rem - nzf
        k = k + in_ok
        ch_end = in_ok & (rem == 0)
        corrupt = corrupt | (in_ok & (k >= 64) & (rem > 0))

        # chain advance over (j, bx, by)
        adv = empty | ch_end
        chain = chain + adv
        mode = torch.where(adv, 0, mode)
        j = j + adv
        wrapj = j == 3
        j = torch.where(wrapj, 0, j)
        bx = bx + wrapj
        wrapx = bx == bw
        bx = torch.where(wrapx, 0, bx)
        by = by + wrapx
        done = done | (adv & (chain >= nch))

    ok = done & ~corrupt & ((st == ANS_SIGNATURE) | (nch == 0))
    return tape, ok, steps


@dataclasses.dataclass(frozen=True)
class Geometry:
    """What place needs of a LanePlan besides inv_order: a program's
    static key (a LanePlan is one batch's data)."""

    B: int
    gy: int
    gx: int
    H: int
    W: int

    @classmethod
    def of(cls, lp) -> "Geometry":
        return cls(lp.B, lp.gy, lp.gx, lp.H, lp.W)


def place(tape: torch.Tensor, lp, inv_order=None) -> torch.Tensor:
    """Phase 2: the tape's coefficient tokens as qimg i32[B, 3, H, W] on the
    tape's device (the port of _placer_fn / place_device).

    `tape` is i32[T, L] with any T that holds every lane's steps; rows
    past them are zero. lp is a LanePlan, or its Geometry with inv_order,
    the plan's i64[B, 3, 64] on the tape's device. Runs one image at a
    time, which bounds the (lanes, chains, 64) index arrays to one image's
    share. Its pieces, in order: lane_major (transpose), chain_cumsum,
    chain_starts (searchsorted), chain_coeffs (gather), to_raster
    (permutation)."""
    dev = tape.device
    g = lp.gy * lp.gx
    if tape.shape[1] != lp.B * g:
        raise ValueError(f"place: {tape.shape[1]} lanes, not {lp.B} x {g} "
                         "groups")
    tl_all = lane_major(tape)
    q = chain_queries(g, dev)
    inv = inv_order if inv_order is not None else torch.from_numpy(
        np.ascontiguousarray(lp.inv_order)).to(dev)
    out = torch.empty((lp.B, 3, lp.H, lp.W), dtype=torch.int32, device=dev)
    for b in range(lp.B):
        tl = tl_all[b * g:(b + 1) * g]
        starts = chain_starts(chain_cumsum(tl), q)
        out[b] = to_raster(chain_coeffs(tl, starts), inv[b], lp)
    return out


def lane_major(tape: torch.Tensor) -> torch.Tensor:
    """place's transpose: the tape [T, L] as [L, T]."""
    return tape.t().contiguous()


def chain_queries(groups: int, device) -> torch.Tensor:
    """1..C for each of `groups` lanes: the chain counts chain_starts
    looks for (C, the chains of a full group)."""
    C = GROUP_BLOCKS * GROUP_BLOCKS * 3
    return torch.arange(1, C + 1, dtype=torch.int32,
                        device=device).expand(groups, C).contiguous()


def chain_cumsum(tl: torch.Tensor) -> torch.Tensor:
    """Chain starts seen up to each step of each lane of tl [lanes, T]."""
    return ((tl >> 30) & 1).cumsum(1, dtype=torch.int32)


def chain_starts(cum: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """starts[l, c]: the first step t with cum[l, t] == c + 1."""
    return torch.searchsorted(cum, q)


def chain_coeffs(tl: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Each chain's 64 coefficients [lanes, C, 64] in chain-step order,
    gathered from tl [lanes, T] at `starts`."""
    g, T = tl.shape
    C = starts.shape[1]
    k = torch.arange(64, device=tl.device)
    nxt = torch.cat([starts[:, 1:], torch.full_like(starts[:, :1], T)], 1)
    idx = (starts[:, :, None] + k).clamp(max=T - 1)
    vals = tl.gather(1, idx.reshape(g, -1)).reshape(g, C, 64)
    # steps 1..63 of each chain; a shorter chain's next steps belong to the
    # next chain
    valid = (k >= 1) & (k < (nxt - starts)[:, :, None])
    u = torch.where(valid, vals & TAPE_VAL, 0)
    return torch.where((u & 1) == 1, -((u + 1) >> 1), u >> 1)


def to_raster(coeff: torch.Tensor, inv_b: torch.Tensor,
              lp: LanePlan) -> torch.Tensor:
    """One image's chain coefficients [groups, C, 64] as its qimg planes
    [3, H, W], through the coefficient order inv_b [3, 64]."""
    # (groups, chains, 64) -> (gy, gx, by, bx, 3, 64); j -> ci (1, 0, 2)
    c6 = coeff.reshape(lp.gy, lp.gx, GROUP_BLOCKS, GROUP_BLOCKS, 3, 64)
    c6 = torch.cat([c6[..., 1:2, :], c6[..., 0:1, :], c6[..., 2:3, :]], -2)
    # raster position p takes chain step inv[ci, p] (0: unset)
    ib = inv_b.expand(c6.shape)
    perm = torch.where(ib == 0, 0, c6.gather(5, ib))
    p8 = perm.reshape(lp.gy, lp.gx, GROUP_BLOCKS, GROUP_BLOCKS, 3, 8, 8)
    # -> (3, gy, by, ry, gx, bx, rx)
    return p8.permute(4, 0, 2, 5, 1, 3, 6).reshape(3, lp.H, lp.W)
