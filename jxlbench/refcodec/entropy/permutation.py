"""Entropy-coded permutations (TOC order, coefficient orders).

Mirrors ReadPermutation/DecodePermutation (coeff_order.cc:34-77) and
TokenizePermutation/EncodePermutation (enc_coeff_order.cc:239-280):
Lehmer-code the permutation, then code (end, lehmer...) as hybrid uints in
kPermutationContexts contexts chosen from the previous value.
"""

from __future__ import annotations

from ..base.status import JXLError
from ..io.bits import BitReader
from ..io.lehmer import compute_lehmer_code, decode_lehmer_code
from .decode import ANSSymbolReader
from .encode import Token
from .hybrid_uint import PERMUTATION_UINT_CONFIG

PERMUTATION_CONTEXTS = 8  # coeff_order_fwd.h


def coeff_order_context(val: int) -> int:
    token, _, _ = PERMUTATION_UINT_CONFIG.encode(val)
    return min(token, PERMUTATION_CONTEXTS - 1)


def read_permutation(skip: int, size: int, r: BitReader,
                     reader: ANSSymbolReader, context_map):
    """coeff_order.cc:34-60."""
    code = reader.code
    if size >= 64:
        from ..native_ext import (NativeCodes, ans_read_permutation_native,
                                  get_lib)

        lib = get_lib()
        if lib is not None:
            ncodes = getattr(reader, "_native_codes", None)
            if ncodes is None:
                ncodes = NativeCodes(code, context_map)
                reader._native_codes = ncodes
            perm, bitpos, state = ans_read_permutation_native(
                lib, r.data, r.total_bits_consumed(), reader.state,
                ncodes, skip, size)
            r.seek_bits(bitpos)
            reader.state = state
            return [int(v) for v in perm]
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

