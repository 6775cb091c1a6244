"""Histogram clustering for context maps.

Greedy agglomerative clustering by entropy-cost delta, modeled on
enc_cluster.cc (FastClusterHistograms): seed with the most-populous
histograms, assign the rest to the cheapest cluster, capped at
CLUSTERS_LIMIT. The cost evaluation is vectorized: clusters live in one
padded (k, alphabet) count matrix and every candidate's merge cost
against ALL clusters is one numpy expression (entropy via the x*log2(x)
identity), not a per-cluster Python loop.
"""

from __future__ import annotations

import math

import numpy as np

from .params import CLUSTERS_LIMIT


def _xlogx(a: np.ndarray) -> np.ndarray:
    """Elementwise x*log2(x) with 0*log2(0) == 0."""
    out = np.zeros_like(a, dtype=np.float64)
    nz = a > 0
    an = a[nz].astype(np.float64)
    out[nz] = an * np.log2(an)
    return out


def cluster_histograms(histograms, max_clusters: int = CLUSTERS_LIMIT):
    """Returns (clustered_histograms, mapping list ctx -> cluster id)."""
    n = len(histograms)
    if n == 0:
        return [], []
    width = max((len(h) for h in histograms), default=0)
    hm = np.zeros((n, max(width, 1)), dtype=np.int64)
    for i, h in enumerate(histograms):
        hm[i, : len(h)] = h
    totals = hm.sum(axis=1)
    # per-histogram self-entropy and symbol x*log2(x) terms, all at once
    xlx = _xlogx(hm)
    with np.errstate(divide="ignore"):
        tot_l = np.where(totals > 0,
                         totals * np.log2(np.maximum(totals, 1)), 0.0)
    self_ent = tot_l - xlx.sum(axis=1)
    order = np.argsort(-totals, kind="stable")
    # Seed clusters with the largest histograms (up to a small seed count),
    # then greedily assign/merge.
    max_seeds = min(max_clusters, 64)
    cl_counts = np.zeros((max_seeds, hm.shape[1]), dtype=np.int64)
    cl_totals = np.zeros(max_seeds, dtype=np.int64)
    cl_ent = np.zeros(max_seeds, dtype=np.float64)
    cl_len = np.zeros(max_seeds, dtype=np.int64)
    lens = np.array([len(h) for h in histograms], dtype=np.int64)
    k = 0
    mapping = [0] * n
    new_costs = 40.0 + 2.0 * (hm > 0).sum(axis=1)
    for idx in order:
        idx = int(idx)
        h = hm[idx]
        t = int(totals[idx])
        if t == 0 and k > 0:
            # empty histograms join cluster 0 for free
            mapping[idx] = 0
            continue
        best_j, best_cost = -1, math.inf
        if k > 0:
            merged = cl_counts[:k] + h[None, :]
            mt = cl_totals[:k] + t
            ent_m = mt * np.log2(np.maximum(mt, 1)) \
                - _xlogx(merged).sum(axis=1)
            costs = ent_m - cl_ent[:k] - self_ent[idx]
            best_j = int(np.argmin(costs))
            best_cost = float(costs[best_j])
        # cost of a new cluster ~ histogram serialization overhead (~40 bits
        # small / proportional to alphabet). Open a new cluster when merging
        # is more expensive and we have room.
        if k < max_seeds and (best_j < 0 or best_cost > new_costs[idx]):
            mapping[idx] = k
            cl_counts[k] = h
            cl_totals[k] = t
            cl_ent[k] = self_ent[idx]
            cl_len[k] = lens[idx]
            k += 1
        else:
            mapping[idx] = best_j
            cl_counts[best_j] += h
            cl_totals[best_j] += t
            cl_ent[best_j] = float(ent_m[best_j])
            cl_len[best_j] = max(cl_len[best_j], lens[idx])
    # Renumber clusters so that ids appear in first-use (context) order; the
    # format does not require it, but it compresses the context map better.
    remap = {}
    for ctx in range(n):
        c = mapping[ctx]
        if c not in remap:
            remap[c] = len(remap)
    new_clusters = [None] * len(remap)
    for old, new in remap.items():
        new_clusters[new] = list(cl_counts[old][: cl_len[old]])
    mapping = [remap[c] for c in mapping]
    return new_clusters, mapping
