"""ANS histogram (de)serialization and normalization.

Decode mirrors ReadHistogram (dec_ans.cc:51-185); encode mirrors
NormalizeCounts/EncodeCounts/EncodeFlatHistogram (enc_ans.cc:113-373).
"""

from __future__ import annotations

import math

from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from .params import ANS_LOG_TAB_SIZE, ANS_TAB_SIZE

# Static Huffman code for logcounts: decode table indexed by 7 peeked bits
# -> (bits, value) (dec_ans.cc:103-119); encode tables (enc_ans.cc:104-110).
LOG_COUNT_BIT_LENGTHS = (5, 4, 4, 4, 4, 4, 3, 3, 3, 3, 3, 6, 7, 7)
LOG_COUNT_SYMBOLS = (17, 11, 15, 3, 9, 7, 4, 2, 5, 6, 0, 33, 1, 65)

_HUFF = [
    (3, 10), (7, 12), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
    (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
    (3, 10), (5, 0), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
    (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
    (3, 10), (6, 11), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
    (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
    (3, 10), (5, 0), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
    (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
    (3, 10), (7, 13), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
    (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
    (3, 10), (5, 0), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
    (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
    (3, 10), (6, 11), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
    (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
    (3, 10), (5, 0), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
    (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
]

MAX_NUM_SYMBOLS_FOR_SMALL_CODE = 4


def get_population_count_precision(logcount: int, shift: int) -> int:
    """ans_common.h:27-33."""
    r = min(logcount, shift - ((ANS_LOG_TAB_SIZE - logcount) >> 1))
    return max(r, 0)


def create_flat_histogram(length: int, total: int = ANS_TAB_SIZE) -> list:
    """ans_common.cc:18-28: counts differ by at most one, sum == total."""
    count = total // length
    result = [count] * length
    for i in range(total % length):
        result[i] += 1
    return result


def decode_varlen_uint8(r: BitReader) -> int:
    if r.read_bits(1):
        nbits = r.read_bits(3)
        if nbits == 0:
            return 1
        return r.read_bits(nbits) + (1 << nbits)
    return 0


def store_varlen_uint8(n: int, w: BitWriter) -> None:
    assert n <= 255
    if n == 0:
        w.write(1, 0)
    else:
        w.write(1, 1)
        nbits = n.bit_length() - 1
        w.write(3, nbits)
        w.write(nbits, n - (1 << nbits))


def read_histogram(r: BitReader, precision_bits: int = ANS_LOG_TAB_SIZE) -> list:
    """Decode one normalized histogram (dec_ans.cc:51-185)."""
    rng = 1 << precision_bits
    if r.read_bits(1):  # simple code
        num_symbols = r.read_bits(1) + 1
        symbols = [decode_varlen_uint8(r) for _ in range(num_symbols)]
        counts = [0] * (max(symbols) + 1)
        if num_symbols == 1:
            counts[symbols[0]] = rng
        else:
            if symbols[0] == symbols[1]:
                raise JXLError("corrupt simple histogram")
            counts[symbols[0]] = r.read_bits(precision_bits)
            counts[symbols[1]] = rng - counts[symbols[0]]
        return counts
    if r.read_bits(1):  # flat
        alphabet_size = decode_varlen_uint8(r) + 1
        if alphabet_size > rng:
            raise JXLError("flat histogram too large")
        return create_flat_histogram(alphabet_size, rng)
    # general: Elias-gamma-ish shift, then static-huffman logcounts
    upper_bound_log = (ANS_LOG_TAB_SIZE + 1).bit_length() - 1
    log = 0
    while log < upper_bound_log:
        if r.read_bits(1) == 0:
            break
        log += 1
    shift = (r.read_bits(log) | (1 << log)) - 1
    if shift > ANS_LOG_TAB_SIZE + 1:
        raise JXLError("invalid shift value")
    length = decode_varlen_uint8(r) + 3
    counts = [0] * length
    logcounts = [0] * length
    same = [0] * length
    omit_log, omit_pos = -1, -1
    i = 0
    while i < length:
        idx = r.peek_bits(7)
        nbits, val = _HUFF[idx]
        r.skip_bits(nbits)
        logcounts[i] = val
        if val == ANS_LOG_TAB_SIZE + 1:  # RLE
            rle_length = decode_varlen_uint8(r)
            same[i] = rle_length + 5
            i += rle_length + 4
            continue
        if val > omit_log:
            omit_log = val
            omit_pos = i
        i += 1
    if omit_pos < 0:
        raise JXLError("invalid histogram")
    if omit_pos + 1 < length and logcounts[omit_pos + 1] == ANS_TAB_SIZE + 1:
        raise JXLError("invalid histogram")
    total_count = 0
    prev = 0
    numsame = 0
    for i in range(length):
        if same[i]:
            numsame = same[i] - 1
            prev = counts[i - 1] if i > 0 else 0
        if numsame > 0:
            counts[i] = prev
            numsame -= 1
        else:
            code = logcounts[i]
            if i == omit_pos or code == 0:
                total_count += counts[i]
                continue
            if code == 1:
                counts[i] = 1
            else:
                bitcount = get_population_count_precision(code - 1, shift)
                counts[i] = (1 << (code - 1)) + (
                    r.read_bits(bitcount) << (code - 1 - bitcount))
        total_count += counts[i]
    counts[omit_pos] = rng - total_count
    if counts[omit_pos] <= 0:
        raise JXLError("invalid histogram count")
    return counts


def smallest_increment(count: int, shift: int) -> int:
    bits = count.bit_length() - 1 if count > 0 else -1
    drop_bits = bits - get_population_count_precision(bits, shift)
    return 1 if drop_bits < 0 else (1 << drop_bits)


def _rebalance(targets, max_symbol, table_size, shift, counts,
               minimize_error_of_sum):
    """RebalanceHistogram (enc_ans.cc:120-172). Returns omit_pos or None."""
    ssum = 0
    sum_nonrounded = 0.0
    remainder_pos = 0
    remainder_log = -1
    for n in range(max_symbol):
        if 0 < targets[n] < 1.0:
            counts[n] = 1
            sum_nonrounded += targets[n]
            ssum += 1
    discount_ratio = (table_size - ssum) / (table_size - sum_nonrounded)
    if not (0 < discount_ratio <= 1.0):
        raise JXLError("bad discount ratio")
    for n in range(max_symbol):
        if targets[n] >= 1.0:
            sum_nonrounded += targets[n]
            cnt = int(targets[n] * discount_ratio)
            if cnt == 0:
                cnt = 1
            if cnt == table_size:
                cnt = table_size - 1
            inc = smallest_increment(cnt, shift)
            cnt -= cnt & (inc - 1)
            target = (int(sum_nonrounded) - ssum) if minimize_error_of_sum \
                else int(targets[n])
            if cnt == 0 or (target >= cnt + inc // 2 and cnt + inc < table_size):
                cnt += inc
            counts[n] = cnt
            ssum += cnt
            count_log = cnt.bit_length() - 1
            if count_log > remainder_log:
                remainder_pos = n
                remainder_log = count_log
    counts[remainder_pos] -= ssum - table_size
    if counts[remainder_pos] <= 0:
        return None
    return remainder_pos


def normalize_counts(counts: list, precision_bits: int, shift: int):
    """NormalizeCounts (enc_ans.cc:176-221).

    Mutates counts in place so they sum to 1<<precision_bits.
    Returns (omit_pos, num_symbols, symbols[:4]).
    """
    table_size = 1 << precision_bits
    total = sum(counts)
    symbols = []
    max_symbol = 0
    for n, c in enumerate(counts):
        if c > 0:
            if len(symbols) < MAX_NUM_SYMBOLS_FOR_SMALL_CODE:
                symbols.append(n)
            max_symbol = n + 1
    symbol_count = sum(1 for c in counts if c > 0)
    if symbol_count == 0:
        return 0, 0, symbols
    if symbol_count == 1:
        counts[symbols[0]] = table_size
        return 0, 1, symbols
    if symbol_count > table_size:
        raise JXLError("too many entries in ANS histogram")
    norm = table_size / total
    targets = [norm * counts[n] for n in range(max_symbol)]
    omit_pos = _rebalance(targets, max_symbol, table_size, shift, counts, False)
    if omit_pos is None:
        omit_pos = _rebalance(targets, max_symbol, table_size, shift, counts, True)
        if omit_pos is None:
            raise JXLError("couldn't rebalance histogram")
    return omit_pos, symbol_count, symbols


def encode_counts(counts, alphabet_size, omit_pos, num_symbols, shift,
                  symbols, w) -> None:
    """EncodeCounts (enc_ans.cc:253-364). w needs only .write(n, v)."""
    if num_symbols <= 2:
        w.write(1, 1)  # small-tree marker
        if num_symbols == 0:
            w.write(1, 0)
            store_varlen_uint8(0, w)
        else:
            w.write(1, num_symbols - 1)
            for i in range(num_symbols):
                store_varlen_uint8(symbols[i], w)
        if num_symbols == 2:
            w.write(ANS_LOG_TAB_SIZE, counts[symbols[0]])
        return
    w.write(1, 0)  # not small
    w.write(1, 0)  # not flat
    # RLE runs (value at first element of each run)
    same = [0] * alphabet_size
    last = 0
    for i in range(1, alphabet_size):
        if (counts[i] != counts[last] or i + 1 == alphabet_size
                or (i - last) >= 255 or i == omit_pos or i == omit_pos + 1):
            same[last] = i - last
            last = i + 1
    length = 0
    logcounts = [0] * alphabet_size
    omit_log = 0
    for i in range(alphabet_size):
        if not (0 <= counts[i] <= ANS_TAB_SIZE):
            raise JXLError("count out of range")
        if i == omit_pos:
            length = i + 1
        elif counts[i] > 0:
            logcounts[i] = counts[i].bit_length()
            length = i + 1
            if i < omit_pos:
                omit_log = max(omit_log, logcounts[i] + 1)
            else:
                omit_log = max(omit_log, logcounts[i])
    logcounts[omit_pos] = omit_log
    # Elias-gamma-like shift code
    upper_bound_log = (ANS_LOG_TAB_SIZE + 1).bit_length() - 1
    log = (shift + 1).bit_length() - 1
    w.write(log, (1 << log) - 1)
    if log != upper_bound_log:
        w.write(1, 0)
    w.write(log, ((1 << log) - 1) & (shift + 1))
    if length - 3 > 255:
        raise JXLError("histogram length too large to encode")
    store_varlen_uint8(length - 3, w)
    rle = ANS_LOG_TAB_SIZE + 1
    min_reps = 4
    i = 0
    while i < length:
        if i > 0 and same[i - 1] > min_reps:
            w.write(LOG_COUNT_BIT_LENGTHS[rle], LOG_COUNT_SYMBOLS[rle])
            store_varlen_uint8(same[i - 1] - min_reps - 1, w)
            i += same[i - 1] - 1  # C++: i += n-2 then ++i
            continue
        w.write(LOG_COUNT_BIT_LENGTHS[logcounts[i]],
                LOG_COUNT_SYMBOLS[logcounts[i]])
        i += 1
    i = 0
    while i < length:
        if i > 0 and same[i - 1] > min_reps:
            i += same[i - 1] - 1  # C++: i += n-2 then ++i
            continue
        if logcounts[i] > 1 and i != omit_pos:
            bitcount = get_population_count_precision(logcounts[i] - 1, shift)
            drop_bits = logcounts[i] - 1 - bitcount
            if counts[i] & ((1 << drop_bits) - 1):
                raise JXLError("count not representable at this shift")
            w.write(bitcount, (counts[i] >> drop_bits) - (1 << bitcount))
        i += 1


def encode_flat_histogram(alphabet_size: int, w) -> None:
    w.write(1, 0)
    w.write(1, 1)
    store_varlen_uint8(alphabet_size - 1, w)


class SizeWriter:
    """Bit-counting sink for cost estimation (enc_ans.cc:223-226)."""

    __slots__ = ("size",)

    def __init__(self):
        self.size = 0

    def write(self, n, v):
        self.size += n


def estimate_data_bits(histogram, counts) -> float:
    """enc_ans.cc:70-91."""
    sum_ = 0.0
    for h, c in zip(histogram, counts):
        if h > 0:
            sum_ += h * max(0.0, ANS_LOG_TAB_SIZE - math.log2(max(c, 1)))
    return sum_


def estimate_data_bits_flat(histogram, length) -> float:
    flat_bits = max(math.log2(length), 0.0) if length > 0 else 0.0
    return sum(histogram) * flat_bits


def compute_histo_and_data_cost(histogram, alphabet_size, method) -> float:
    """enc_ans.cc:375-397; method 0 = flat, else shift = method-1."""
    if method == 0:
        return ANS_LOG_TAB_SIZE + 2 + estimate_data_bits_flat(
            histogram[:alphabet_size], alphabet_size)
    shift = method - 1
    counts = list(histogram[:alphabet_size])
    omit_pos, num_symbols, symbols = normalize_counts(
        counts, ANS_LOG_TAB_SIZE, shift)
    sw = SizeWriter()
    encode_counts(counts, alphabet_size, omit_pos, num_symbols, shift, symbols, sw)
    return sw.size + estimate_data_bits(histogram[:alphabet_size], counts)


def compute_best_method(histogram, alphabet_size, strategy: str = "fast"):
    """enc_ans.cc:399-427. Returns (method, cost)."""
    best_cost = compute_histo_and_data_cost(histogram, alphabet_size, 0)
    best_method = 0
    if strategy == "precise":
        shifts = range(ANS_LOG_TAB_SIZE + 1)
    elif strategy == "approximate":
        shifts = range(0, ANS_LOG_TAB_SIZE + 1, 2)
    else:
        shifts = (0, ANS_LOG_TAB_SIZE // 2, ANS_LOG_TAB_SIZE)
    for shift in shifts:
        try:
            c = compute_histo_and_data_cost(histogram, alphabet_size, shift + 1)
        except JXLError:
            continue
        if c < best_cost:
            best_cost = c
            best_method = shift + 1
    return best_method, best_cost
