"""Entropy-coded permutations (TOC order, coefficient orders).

Mirrors ReadPermutation/DecodePermutation (coeff_order.cc:34-77) and
TokenizePermutation/EncodePermutation (enc_coeff_order.cc:239-280):
Lehmer-code the permutation, then code (end, lehmer...) as hybrid uints in
kPermutationContexts contexts chosen from the previous value.
"""

from __future__ import annotations

import numpy as np

from .. import native_ext
from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from ..io.lehmer import compute_lehmer_code, decode_lehmer_code
from .decode import ANSSymbolReader, decode_histograms
from .encode import Token, build_and_encode_histograms, write_tokens
from .hybrid_uint import PERMUTATION_UINT_CONFIG

PERMUTATION_CONTEXTS = 8  # coeff_order_fwd.h


def coeff_order_context(val: int) -> int:
    token, _, _ = PERMUTATION_UINT_CONFIG.encode(val)
    return min(token, PERMUTATION_CONTEXTS - 1)


def read_permutations(skip_sizes, r: BitReader, reader: ANSSymbolReader,
                      context_map) -> list:
    """read_permutation of each (skip, size) in turn: one C call for them
    all where the code is plain rANS and every size is at least 64 (i32
    arrays), else the Python reads (lists)."""
    code = reader.code
    lib = None
    if (not code.use_prefix_code and not code.lz77.enabled
            and min((size for _, size in skip_sizes), default=0) >= 64):
        lib = native_ext.get_lib()
    if lib is None:
        return [_read_permutation(skip, size, r, reader, context_map)
                for skip, size in skip_sizes]
    ncodes = getattr(reader, "_native_codes", None)
    if ncodes is None:
        ncodes = native_ext.NativeCodes(code, context_map)
        reader._native_codes = ncodes
    perms, bitpos, reader.state = native_ext.ans_read_permutations_native(
        lib, r.data, r.total_bits_consumed(), reader.state, ncodes,
        skip_sizes)
    r.seek_bits(bitpos)
    return perms


def read_permutation(skip: int, size: int, r: BitReader,
                     reader: ANSSymbolReader, context_map) -> list:
    """coeff_order.cc:34-60."""
    (perm,) = read_permutations([(skip, size)], r, reader, context_map)
    return np.asarray(perm).tolist()


def _read_permutation(skip: int, size: int, r: BitReader,
                      reader: ANSSymbolReader, context_map) -> list:
    end = reader.read_hybrid_uint(coeff_order_context(size), r, context_map) + skip
    if end > size:
        raise JXLError("invalid permutation size")
    lehmer = [0] * size
    last = 0
    for i in range(skip, end):
        lehmer[i] = reader.read_hybrid_uint(
            coeff_order_context(last), r, context_map)
        last = lehmer[i]
        if lehmer[i] >= size - i:
            raise JXLError("invalid lehmer code")
    return decode_lehmer_code(lehmer)


def decode_permutation(skip: int, size: int, r: BitReader):
    """coeff_order.cc:63-77."""
    code, context_map = decode_histograms(r, PERMUTATION_CONTEXTS)
    reader = ANSSymbolReader(code, r)
    perm = read_permutation(skip, size, r, reader, context_map)
    if not reader.check_final_state():
        raise JXLError("invalid ANS stream in permutation")
    return perm


def tokenize_permutation(order, skip: int, size: int, tokens: list) -> None:
    """enc_coeff_order.cc:239-258."""
    lehmer = compute_lehmer_code(order)
    end = size
    while end > skip and lehmer[end - 1] == 0:
        end -= 1
    tokens.append(Token(coeff_order_context(size), end - skip))
    last = 0
    for i in range(skip, end):
        tokens.append(Token(coeff_order_context(last), lehmer[i]))
        last = lehmer[i]


def encode_permutation(order, skip: int, size: int, w: BitWriter) -> None:
    """enc_coeff_order.cc:264-280."""
    tokens: list = []
    tokenize_permutation(order, skip, size, tokens)
    codes, context_map = build_and_encode_histograms(
        [tokens], PERMUTATION_CONTEXTS, w,
        uint_config=PERMUTATION_UINT_CONFIG)
    write_tokens(tokens, codes, context_map, w)
