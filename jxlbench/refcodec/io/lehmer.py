"""Lehmer (factorial-basis) permutation codes.

Mirrors lib/jxl/lehmer_code.h:31-99 (Fenwick-tree encode, order-statistics
tree decode) — O(n log n).
"""

from __future__ import annotations

from ..base.status import JXLError


def compute_lehmer_code(permutation) -> list:
    """Lehmer code of ``permutation`` (unique indices in [0..n))."""
    n = len(permutation)
    temp = [0] * (n + 1)
    code = [0] * n
    for idx in range(n):
        s = permutation[idx]
        penalty = 0
        i = s + 1
        while i != 0:
            penalty += temp[i]
            i &= i - 1
        if s < penalty:
            raise JXLError("invalid permutation")
        code[idx] = s - penalty
        i = s + 1
        while i < n + 1:
            temp[i] += 1
            i += i & (-i)
    return code


def decode_lehmer_code(code) -> list:
    """Inverse of compute_lehmer_code."""
    n = len(code)
    if n == 0:
        return []
    log2n = max(1, (n - 1).bit_length()) if n > 1 else 0
    padded_n = 1 << log2n
    temp = [0] * (padded_n + 1)
    for i in range(padded_n):
        i1 = i + 1
        temp[i] = i1 & (-i1)
    permutation = [0] * n
    for i in range(n):
        if code[i] + i >= n:
            raise JXLError("invalid lehmer code")
        rank = code[i] + 1
        bit = padded_n
        nxt = 0
        for _ in range(log2n + 1):
            cand = nxt + bit
            bit >>= 1
            if temp[cand - 1] < rank:
                nxt = cand
                rank -= temp[cand - 1]
        permutation[i] = nxt
        nxt += 1
        while nxt <= padded_n:
            temp[nxt - 1] -= 1
            nxt += nxt & (-nxt)
    return permutation
