"""Custom AC coefficient orders.

Per pass, the bitstream may replace the natural (zigzag-generalized) coeff
order of any of the 13 order classes with a signaled permutation, coded as
a Lehmer code over the natural order with the LLF prefix fixed.

Mirrors DecodeCoeffOrders (coeff_order.cc:99-155) and
ComputeCoeffOrder/EncodeCoeffOrders (enc_coeff_order.cc:47-241,296-339).
"""

from __future__ import annotations

import numpy as np

from ..entropy.decode import ANSSymbolReader, decode_histograms
from ..entropy.encode import build_and_encode_histograms, write_tokens
from ..entropy.hybrid_uint import PERMUTATION_UINT_CONFIG
from ..entropy.permutation import (
    PERMUTATION_CONTEXTS,
    read_permutations,
    tokenize_permutation,
)
from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from . import ac_strategy as acs


def _first_strategy_per_order():
    """First raw strategy for each order class, in strategy order
    (the dedup loop of coeff_order.cc:113-118)."""
    out = []
    computed = set()
    for o in range(acs.NUM_STRATEGIES):
        ord_ = acs.STRATEGY_ORDER[o]
        if ord_ in computed:
            continue
        computed.add(ord_)
        out.append((ord_, o))
    return out


def decode_coeff_orders(used_orders: int, r: BitReader) -> dict:
    """Returns {(ord, channel): np.ndarray order} for each signaled order
    class; callers fall back to the natural order for missing keys."""
    orders = {}
    if used_orders == 0:
        return orders
    code, cmap = decode_histograms(r, PERMUTATION_CONTEXTS)
    reader = ANSSymbolReader(code, r)
    used = [(ord_, o) for ord_, o in _first_strategy_per_order()
            if used_orders & (1 << ord_)]
    cbs = [acs.COVERED_X[o] * acs.COVERED_Y[o] for _, o in used]
    perms = iter(read_permutations(
        [(cb, 64 * cb) for cb in cbs for _ in range(3)], r, reader, cmap))
    for ord_, o in used:
        natural = acs.natural_coeff_order(o)
        for c in range(3):
            orders[(ord_, c)] = natural[np.asarray(next(perms),
                                                   dtype=np.int64)]
    if not reader.check_final_state():
        raise JXLError("invalid ANS stream in coefficient orders")
    return orders


def compute_coeff_orders(num_zeros: dict, used_acs_strategies,
                         customize: bool = True):
    """Choose per-order-class coefficient orders from zero counts.

    num_zeros: {(ord, c): int array of per-position zero counts} summed over
    sampled blocks (enc_coeff_order.cc:84-165). Positions are in coefficient
    raster layout. LLF positions are forced first.
    Returns (used_orders bitmask, {(ord, c): order array}).
    """
    used_orders = 0
    orders = {}
    if not customize:
        return 0, orders
    used_ords = {acs.STRATEGY_ORDER[s] for s in used_acs_strategies}
    for ord_, o in _first_strategy_per_order():
        if ord_ not in used_ords or ord_ > 6:
            continue  # no customization for blocks larger than 32x32
        cx, cy = acs.COVERED_X[o], acs.COVERED_Y[o]
        cb = cx * cy
        size = 64 * cb
        natural = acs.natural_coeff_order(o)
        nondefault = False
        cand = {}
        for c in range(3):
            nz = num_zeros.get((ord_, c))
            if nz is None:
                break
            nz = np.asarray(nz, dtype=np.float64).copy()
            # pin LLF first: coefficient layout rows=min, cols=max*8
            wide_cx = max(cx, cy)
            for iy in range(min(cx, cy)):
                nz[iy * 8 * wide_cx:iy * 8 * wide_cx + wide_cx] = -1
            # quantize counts so near-ties keep natural order
            counts = (nz[natural] / np.sqrt(size) + 0.1).astype(np.int64)
            counts[nz[natural] < 0] = -1
            idx = np.argsort(counts, kind="stable")
            cand[c] = natural[idx]
            if not np.array_equal(cand[c], natural):
                nondefault = True
        else:
            if nondefault:
                used_orders |= 1 << ord_
                orders.update({(ord_, c): cand[c] for c in range(3)})
    return used_orders, orders


def encode_coeff_orders(used_orders: int, orders: dict, w: BitWriter) -> None:
    """enc_coeff_order.cc:296-339; writes nothing when used_orders == 0."""
    if used_orders == 0:
        return
    tokens = []
    for ord_, o in _first_strategy_per_order():
        if (used_orders & (1 << ord_)) == 0:
            continue
        cb = acs.COVERED_X[o] * acs.COVERED_Y[o]
        size = 64 * cb
        natural = acs.natural_coeff_order(o)
        # position -> natural-order index ("zigzag" lut)
        lut = np.empty(size, dtype=np.int64)
        lut[natural] = np.arange(size)
        for c in range(3):
            order_zigzag = lut[np.asarray(orders[(ord_, c)])].tolist()
            tokenize_permutation(order_zigzag, cb, size, tokens)
    codes, cmap = build_and_encode_histograms(
        [tokens], PERMUTATION_CONTEXTS, w,
        uint_config=PERMUTATION_UINT_CONFIG)
    write_tokens(tokens, codes, cmap, w)
