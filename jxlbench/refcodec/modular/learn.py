"""MA tree learning (CART) + vectorized channel tokenization.

Vectorized reformulation of enc_ma.cc ComputeBestTree: all local
properties and all static-predictor residuals are shift-arithmetic on the
channel plane, so property extraction and tree evaluation run as NumPy
array ops instead of the reference's per-pixel sample loop. The weighted
predictor (sequential state) is excluded from learned trees
(ModularOptions::TreeMode::kNoWP analog).
"""

from __future__ import annotations

import math

import numpy as np

from ..entropy.encode import TokenArray
from .predict import (
    NUM_NONREF_PROPERTIES,
    P_GRADIENT,
    P_LEFT,
    P_SELECT,
    P_TOP,
    P_ZERO,
    P_AVG0,
)
from .tree import Tree, TreeNode


def neighbor_planes(data: np.ndarray):
    """Edge-case-correct neighbor arrays (context_predict.h:493-500)."""
    d = data.astype(np.int64)
    h, w = d.shape
    left = np.zeros_like(d)
    left[:, 1:] = d[:, :-1]
    left[1:, 0] = d[:-1, 0]
    top = np.empty_like(d)
    top[1:] = d[:-1]
    top[0] = left[0]
    topleft = np.zeros_like(d)
    topleft[1:, 1:] = d[:-1, :-1]
    topleft[:, 0] = left[:, 0]
    topleft[0, 1:] = left[0, 1:]
    topright = np.empty_like(d)
    topright[1:, :-1] = d[:-1, 1:]
    topright[:, -1] = top[:, -1]
    topright[0, :] = top[0, :]
    leftleft = np.empty_like(d)
    leftleft[:, 2:] = d[:, :-2]
    leftleft[:, :2] = left[:, :2]
    toptop = np.empty_like(d)
    toptop[2:] = d[:-2]
    toptop[:2] = top[:2]
    return left, top, topleft, topright, leftleft, toptop


def property_planes(data: np.ndarray, chan: int, group_id: int):
    """(NUM_NONREF_PROPERTIES, H, W) int64 property arrays; WP property
    (index 15) is left as zeros (NoWP trees only)."""
    h, w = data.shape
    left, top, topleft, topright, leftleft, toptop = neighbor_planes(data)
    props = np.zeros((NUM_NONREF_PROPERTIES, h, w), dtype=np.int64)
    props[0] = chan
    props[1] = group_id
    props[2] = np.arange(h)[:, None]
    props[3] = np.arange(w)[None, :]
    props[4] = np.abs(top)
    props[5] = np.abs(left)
    props[6] = top
    props[7] = left
    p9 = left + top - topleft
    prev9 = np.zeros_like(p9)
    prev9[:, 1:] = p9[:, :-1]  # props[9] of the previous pixel; 0 at x=0
    props[8] = left - prev9
    props[9] = p9
    props[10] = left - topleft
    props[11] = topleft - top
    props[12] = top - topright
    props[13] = top - toptop
    props[14] = left - leftleft
    return props


_CG_PREDICTORS = (P_ZERO, P_LEFT, P_TOP, P_AVG0, P_GRADIENT, P_SELECT)


def predictor_planes(data: np.ndarray):
    """Residual plane per static predictor id (vectorized PredictOne)."""
    d = data.astype(np.int64)
    left, top, topleft, topright, leftleft, toptop = neighbor_planes(d)
    m = np.minimum(top, left)
    M = np.maximum(top, left)
    grad = np.where(topleft < m, M,
                    np.where(topleft > M, m, top + left - topleft))
    p = top + left - topleft
    select = np.where(np.abs(p - left) < np.abs(p - top), left, top)
    avg0 = _trunc_div2(left + top)
    return {
        P_ZERO: np.zeros_like(d),
        P_LEFT: left,
        P_TOP: top,
        P_AVG0: avg0,
        P_GRADIENT: grad,
        P_SELECT: select,
    }


def _trunc_div2(v):
    return np.where(v >= 0, v // 2, -((-v) // 2))


# raw-bit count is a function of the (4, 2, 0) hybrid-uint token alone:
# token = 16 + (n - 4) * 4 + msb  =>  nbits = n - 2
_NBITS_OF_TOKEN = np.array(
    [0] * 16 + [(t - 16) // 4 + 2 for t in range(16, 256)], dtype=np.int64)


def _token_hist_bits(counts: np.ndarray) -> float:
    total = counts.sum()
    if total == 0:
        return 0.0
    extra = int((counts * _NBITS_OF_TOKEN[:len(counts)]).sum())
    counts = counts[counts > 0]
    ent = float(-(counts * (np.log2(counts) - math.log2(total))).sum())
    return ent + extra


def _best_predictor(residuals: dict, idx: np.ndarray):
    """residuals: predictor -> pre-tokenized hybrid-uint token array."""
    best_p, best_cost = P_GRADIENT, float("inf")
    for p, tok in residuals.items():
        cost = _token_hist_bits(np.bincount(tok[idx]))
        if cost < best_cost:
            best_p, best_cost = p, cost
    return best_p, best_cost


# properties considered for splits (reference default set,
# options.h:80-82, minus WP)
SPLIT_PROPERTIES = (9, 10, 11, 12, 13, 14, 6, 7, 4, 5, 2, 3)


def learn_tree(channels, max_nodes: int = 127, sample_step: int = 1,
               threshold_bits: float = 120.0) -> Tree:
    """Greedy CART over (properties, residuals) samples.

    channels: list of (data, chan_index, group_id) to learn jointly.
    Returns an encoder-layout Tree (lchild = property > splitval branch).
    """
    prop_samples = []
    res_samples = {p: [] for p in _CG_PREDICTORS}
    for (data, chan, gid) in channels:
        if data.size == 0:
            continue
        props = property_planes(data, chan, gid)
        preds = predictor_planes(data)
        sl = (slice(None, None, sample_step), slice(None, None, sample_step))
        prop_samples.append(
            props[:, sl[0], sl[1]].reshape(NUM_NONREF_PROPERTIES, -1))
        d = data.astype(np.int64)[sl]
        for p in _CG_PREDICTORS:
            res_samples[p].append((d - preds[p][sl]).reshape(-1))
    if not prop_samples:
        return [TreeNode(-1, 0, 0, 0, P_GRADIENT, 0, 1)]
    props = np.concatenate(prop_samples, axis=1)
    from ..entropy.hybrid_uint import DEFAULT_UINT_CONFIG

    # pre-tokenize every predictor's residuals once; the split search then
    # only runs bincounts over index subsets
    residuals = {}
    for p, v in res_samples.items():
        res = np.concatenate(v)
        u = np.where(res >= 0, res * 2, -res * 2 - 1)
        residuals[p] = DEFAULT_UINT_CONFIG.encode_array(u)[0].astype(
            np.int64)
    n = props.shape[1]

    tree: Tree = []

    def build(idx: np.ndarray) -> int:
        """Returns node index in `tree`."""
        node_pos = len(tree)
        tree.append(None)  # placeholder
        best_p, base_cost = _best_predictor(residuals, idx)
        best = None
        if len(tree) + 2 <= max_nodes and len(idx) > 64:
            # all candidate thresholds of one property at once: a 2D
            # (token, bucket) histogram per predictor + prefix sums give
            # every left/right histogram, so the cost of each threshold
            # is one vectorized entropy expression instead of two
            # bincount passes over the sample subset
            toks = {p: residuals[p][idx] for p in residuals}
            ntok = max(int(t.max()) + 1 if len(t) else 1
                       for t in toks.values())
            nb_tab = _NBITS_OF_TOKEN[:ntok].astype(np.float64)
            for prop in SPLIT_PROPERTIES:
                vals = props[prop][idx]
                # percentiles over a stride-subsample: the thresholds
                # are heuristic candidates, and the exact split cost is
                # still evaluated on the FULL sample set below
                pv = vals[::max(1, len(vals) // 8192)]
                qs = np.unique(np.percentile(
                    pv, [12.5, 25, 37.5, 50, 62.5, 75,
                         87.5]).astype(np.int64))
                if len(qs) == 0:
                    continue
                # bucket b: first q >= val; "val <= qs[k]" <=> b <= k
                bucket = np.searchsorted(qs, vals, side="left")
                nq = len(qs)
                cl_min = np.full(nq, np.inf)
                cr_min = np.full(nq, np.inf)
                nr_k = None
                for p, tok in toks.items():
                    c2 = np.bincount(tok * (nq + 1) + bucket,
                                     minlength=ntok * (nq + 1)).reshape(
                                         ntok, nq + 1)
                    right = np.cumsum(c2, axis=1)[:, :nq]  # <= qs[k]
                    tot = c2.sum(axis=1, keepdims=True)  # full histogram
                    left = tot - right
                    if nr_k is None:
                        nr_k = right.sum(axis=0)
                        n_all = int(tot.sum())

                    def _cost(h):
                        t_ = h.sum(axis=0)
                        with np.errstate(divide="ignore",
                                         invalid="ignore"):
                            xl = np.where(h > 0, h * np.log2(
                                np.maximum(h, 1)), 0.0)
                            tl = np.where(t_ > 0, t_ * np.log2(
                                np.maximum(t_, 1)), 0.0)
                        return tl - xl.sum(axis=0) \
                            + (h * nb_tab[:, None]).sum(axis=0)

                    cr = _cost(right.astype(np.float64))
                    cl = _cost(left.astype(np.float64))
                    cr_min = np.minimum(cr_min, cr)
                    cl_min = np.minimum(cl_min, cl)
                valid = (nr_k > 0) & (nr_k < n_all)
                gains = np.where(valid,
                                 base_cost - (cl_min + cr_min), -np.inf)
                k = int(np.argmax(gains))
                if gains[k] > threshold_bits and (
                        best is None or gains[k] > best[0]):
                    best = (float(gains[k]), prop, int(qs[k]))
        if best is None:
            tree[node_pos] = TreeNode(-1, 0, 0, 0, best_p, 0, 1)
            return node_pos
        _, prop, t = best
        vals = props[prop][idx]
        lpos = build(idx[vals > t])
        rpos = build(idx[vals <= t])
        tree[node_pos] = TreeNode(prop, t, lpos, rpos, 0, 0, 1)
        return node_pos

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(10000)
    try:
        build(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)
    return tree


def tokenize_channel_vectorized(data: np.ndarray, chan: int, group_id: int,
                                dec_tree: Tree, tokens: list) -> bool:
    """Vectorized tokenization for WP-free trees with static predictors.

    Returns False (caller must fall back to the scalar path) if the tree
    needs the weighted predictor or reference properties."""
    from .tree import filter_tree

    ftree, uses_wp, max_prop = filter_tree(dec_tree, (chan, group_id))
    if uses_wp or max_prop >= NUM_NONREF_PROPERTIES - 1:
        return False
    for node in ftree:
        if node.property == -1 and node.predictor not in _CG_PREDICTORS:
            return False
    h, w = data.shape
    if h == 0 or w == 0:
        return True
    props = property_planes(data, chan, group_id)
    preds = predictor_planes(data)
    d = data.astype(np.int64)
    ctx_plane = np.zeros((h, w), dtype=np.int32)
    res_plane = np.zeros((h, w), dtype=np.int64)
    # evaluate the tree with masks
    stack = [(0, np.ones((h, w), dtype=bool))]
    while stack:
        pos, mask = stack.pop()
        node = ftree[pos]
        if node.property == -1:
            ctx_plane[mask] = node.context
            res = d - preds[node.predictor] - node.predictor_offset
            if node.multiplier != 1:
                # a residual the multiplier doesn't divide cannot be
                # coded losslessly with this leaf; the scalar path
                # raises — falling back keeps the loud error instead of
                # a silent floor-divided wrong token
                if np.any(res[mask] % node.multiplier):
                    return False
                res = res // node.multiplier
            res_plane[mask] = res[mask]
            continue
        go_left = props[node.property] > node.splitval
        stack.append((node.lchild, mask & go_left))
        stack.append((node.rchild, mask & ~go_left))
    flat_ctx = ctx_plane.reshape(-1)
    flat_res = res_plane.reshape(-1)
    packed = np.where(flat_res >= 0, flat_res * 2, -flat_res * 2 - 1)
    tokens.append(TokenArray(flat_ctx, packed))
    return True
