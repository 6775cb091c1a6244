"""Host-side chain metadata for the TPU rANS decoder (ops/ans_tpu.py).

A "chain" is one block-channel coefficient stream: for every origin
block in the group (raster order), three chains in the y, x, b visit
order of dec_group.cc. Each chain's decode-relevant facts pack into one
i32 so the kernel can pull them through a windowed meta stream:

  bits 0-5   block context (bc) for this channel
  bits 6-9   log2(covered blocks) (l2; size = 64 << l2)
  bits 10-14 block x within the group (for the nzeros predictor row)
  bit  15    block is in the group's first row (top predictor absent)
  bits 16-20 covered_x - 1 (nz row-write span)
  bits 21-22 channel index (plane: 0=x, 1=y, 2=b)
"""

from __future__ import annotations

import numpy as np


def lane_chain_meta(state, gx, gy, bctx_lut_pair):
    """Chain metadata for one AC group. Returns (meta i32[n_chains],
    block i32[n_chains] (by<<6|bx within group), ci i32[n_chains],
    sizes i64[n_chains] (worst-case chain steps = size - cb))."""
    from ..vardct import ac_strategy as acs

    bctx_lut, qf_thr = bctx_lut_pair
    nqf = len(qf_thr)
    fd = state.fd
    gdim = fd.group_dim // 8
    by0 = gy * gdim
    bx0 = gx * gdim
    bh = min(fd.ysize_blocks - by0, gdim)
    bw = min(fd.xsize_blocks - bx0, gdim)
    strat = state.strategy[by0:by0 + bh, bx0:bx0 + bw]
    orig = state.is_origin[by0:by0 + bh, bx0:bx0 + bw]
    quant = state.raw_quant_field[by0:by0 + bh, bx0:bx0 + bw]

    pos = np.argwhere(orig)
    if len(pos) == 0:
        z = np.zeros(0, np.int32)
        return z, z, z, np.zeros(0, np.int64)
    # raster order (argwhere is row-major already)
    bys, bxs = pos[:, 0].astype(np.int64), pos[:, 1].astype(np.int64)
    ss = strat[bys, bxs].astype(np.int64)
    cxs = np.asarray(acs.COVERED_X, np.int64)[ss]
    l2s = np.asarray(acs.LOG2_COVERED, np.int64)[ss]
    ords = np.asarray(acs.STRATEGY_ORDER, np.int64)[ss]
    q = quant[bys, bxs].astype(np.int64)
    qfi = np.zeros(len(q), np.int64)
    for t in range(nqf):
        qfi += q > qf_thr[t]

    n = len(pos)
    meta = np.zeros(n * 3, np.int32)
    block = np.zeros(n * 3, np.int32)
    ci_arr = np.zeros(n * 3, np.int32)
    sizes = np.zeros(n * 3, np.int64)
    for j, ci in enumerate((1, 0, 2)):        # y, x, b visit order
        cidx = ci ^ 1 if ci < 2 else 2
        bc = bctx_lut[cidx, ords, qfi]
        m = (bc.astype(np.int64) & 63) \
            | (l2s << 6) | (bxs << 10) | ((bys == 0).astype(np.int64) << 15) \
            | ((cxs - 1) << 16) | (ci << 21)
        meta[j::3] = m.astype(np.int32)
        block[j::3] = ((bys << 6) | bxs).astype(np.int32)
        ci_arr[j::3] = ci
        sizes[j::3] = (64 << l2s) - (1 << l2s)
    return meta, block, ci_arr, sizes
