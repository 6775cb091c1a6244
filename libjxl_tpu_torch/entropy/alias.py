"""Alias table for O(1) rANS symbol lookup.

Mirrors InitAliasTable/AliasTable::Lookup (ans_common.cc:55-158,
ans_common.h:61-135). Entries are stored as parallel NumPy arrays so bulk
decode can gather over them; the same arrays feed the TPU Pallas decode
kernel (gather + branchless renorm).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..base.status import JXLError
from .params import ANS_LOG_TAB_SIZE, ANS_TAB_SIZE


@dataclass
class AliasTable:
    """Parallel-array alias table; index = entry id in [0, 1<<log_alpha_size)."""

    cutoff: np.ndarray        # uint16
    right_value: np.ndarray   # uint16
    freq0: np.ndarray         # uint16
    offsets1: np.ndarray      # uint16 (only meaningful when pos >= cutoff)
    freq1: np.ndarray         # uint16 (freq of right_value)
    log_alpha_size: int

    @property
    def log_entry_size(self) -> int:
        return ANS_LOG_TAB_SIZE - self.log_alpha_size

    def lookup(self, value: int):
        """-> (symbol, offset, freq) for one state residue (ans_common.h:84-135)."""
        les = self.log_entry_size
        i = value >> les
        pos = value & ((1 << les) - 1)
        if pos >= self.cutoff[i]:
            return (int(self.right_value[i]), int(self.offsets1[i]) + pos,
                    int(self.freq1[i]))
        return (i, pos, int(self.freq0[i]))

    def lookup_array(self, values: np.ndarray):
        """Vectorized lookup over a batch of state residues."""
        les = self.log_entry_size
        i = values >> les
        pos = values & ((1 << les) - 1)
        greater = pos >= self.cutoff[i]
        sym = np.where(greater, self.right_value[i], i)
        off = np.where(greater, self.offsets1[i], 0) + pos
        freq = np.where(greater, self.freq1[i], self.freq0[i])
        return sym, off, freq


def init_alias_table(distribution, log_alpha_size: int,
                     log_range: int = ANS_LOG_TAB_SIZE) -> AliasTable:
    """ans_common.cc:55-158."""
    rng = 1 << log_range
    table_size = 1 << log_alpha_size
    if table_size > rng:
        raise JXLError("alias table too large")
    dist = list(distribution)
    while dist and dist[-1] == 0:
        dist.pop()
    if not dist:
        dist = [rng]
    if len(dist) > table_size:
        raise JXLError("distribution too long for alias table")
    entry_size = rng >> log_alpha_size

    cutoff = np.zeros(table_size, dtype=np.uint16)
    right_value = np.zeros(table_size, dtype=np.uint16)
    freq0 = np.zeros(table_size, dtype=np.uint16)
    offsets1 = np.zeros(table_size, dtype=np.uint16)
    freq1 = np.zeros(table_size, dtype=np.uint16)

    if sum(dist) != rng:
        raise JXLError("distribution sum mismatch")
    single_symbol = -1
    for sym, v in enumerate(dist):
        if v == ANS_TAB_SIZE:
            single_symbol = sym
    if single_symbol != -1:
        sym = single_symbol
        for i in range(table_size):
            right_value[i] = sym
            cutoff[i] = 0
            offsets1[i] = entry_size * i
            freq0[i] = 0
            freq1[i] = ANS_TAB_SIZE
        return AliasTable(cutoff, right_value, freq0, offsets1, freq1,
                          log_alpha_size)

    underfull = []
    overfull = []
    cutoffs = [0] * table_size
    for i, v in enumerate(dist):
        cutoffs[i] = v
        if v > entry_size:
            overfull.append(i)
        elif v < entry_size:
            underfull.append(i)
    for i in range(len(dist), table_size):
        cutoffs[i] = 0
        underfull.append(i)
    while overfull:
        over_i = overfull.pop()
        if not underfull:
            raise JXLError("alias table invariant violated")
        under_i = underfull.pop()
        underfull_by = entry_size - cutoffs[under_i]
        cutoffs[over_i] -= underfull_by
        right_value[under_i] = over_i
        offsets1[under_i] = cutoffs[over_i]
        if cutoffs[over_i] < entry_size:
            underfull.append(over_i)
        elif cutoffs[over_i] > entry_size:
            overfull.append(over_i)
    for i in range(table_size):
        if cutoffs[i] == entry_size:
            right_value[i] = i
            offsets1[i] = 0
            cutoff[i] = 0
        else:
            offsets1[i] = int(offsets1[i]) - cutoffs[i]
            cutoff[i] = cutoffs[i]
        f0 = dist[i] if i < len(dist) else 0
        i1 = int(right_value[i])
        f1 = dist[i1] if i1 < len(dist) else 0
        freq0[i] = f0
        freq1[i] = f1
    return AliasTable(cutoff, right_value, freq0, offsets1, freq1,
                      log_alpha_size)


ALIAS_FIELDS = ("cutoff", "right_value", "freq0", "offsets1", "freq1")


def alias_table_views(tables: np.ndarray, log_alpha_size: int) -> list:
    """AliasTable objects over (5, n, 1 << log_alpha_size) uint16 rows
    (native_ext.decode_ans_histograms_native's layout): table k's fields
    are views of tables[:, k]."""
    return [AliasTable(*fields, log_alpha_size)
            for fields in zip(*map(list, tables))]


def stacked_alias_fields(tables: list, log_alpha_size: int) -> np.ndarray:
    """The tables' fields as one (5, n, 1 << log_alpha_size) uint16 array,
    in ALIAS_FIELDS order: the array they view where alias_table_views
    made them, else a copy."""
    n, size = len(tables), 1 << log_alpha_size
    base = tables[0].cutoff.base if n else None
    if isinstance(base, np.ndarray) and base.shape == (5, n, size) \
            and base.dtype == np.uint16:
        start, row = base.ctypes.data, base.strides[1]
        if all(t.cutoff.base is base
               and t.cutoff.__array_interface__["data"][0] == start + k * row
               for k, t in enumerate(tables)):
            return base
    out = np.zeros((5, n, size), dtype=np.uint16)
    for k, t in enumerate(tables):
        for f, name in enumerate(ALIAS_FIELDS):
            out[f, k] = getattr(t, name)
    return out


def build_reverse_map(table: AliasTable, alphabet_size: int):
    """For the encoder: reverse_map[symbol][offset] = state residue
    (ANSBuildInfoTable, enc_ans.cc:44-68). Returns a dense int32 array of
    shape [alphabet_size, max_freq] (unused slots = -1) plus freqs."""
    residues = np.arange(ANS_TAB_SIZE, dtype=np.int64)
    sym, off, freq = table.lookup_array(residues)
    freqs = np.zeros(max(alphabet_size, 1), dtype=np.int32)
    for s in range(alphabet_size):
        mask = sym == s
        freqs[s] = int(freq[mask][0]) if mask.any() else 0
    max_freq = int(freqs.max()) if len(freqs) else 0
    rev = np.full((max(alphabet_size, 1), max(max_freq, 1)), -1, dtype=np.int32)
    rev[sym, off] = residues
    return rev, freqs
