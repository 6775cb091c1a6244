"""Hybrid-uint token split: value <-> (token, nbits, bits).

Mirrors HybridUintConfig (dec_ans.h:68-101): tokens below ``split_token``
carry the value directly; larger values encode exponent + msb/lsb digits in
the token and the remaining mantissa as raw bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class HybridUintConfig:
    split_exponent: int = 4
    msb_in_token: int = 2
    lsb_in_token: int = 0

    @property
    def split_token(self) -> int:
        return 1 << self.split_exponent

    def encode(self, value: int):
        """-> (token, nbits, bits)."""
        if value < self.split_token:
            return value, 0, 0
        n = value.bit_length() - 1
        m = value - (1 << n)
        msb, lsb = self.msb_in_token, self.lsb_in_token
        token = (self.split_token
                 + ((n - self.split_exponent) << (msb + lsb))
                 + ((m >> (n - msb)) << lsb)
                 + (m & ((1 << lsb) - 1)))
        nbits = n - msb - lsb
        bits = (value >> lsb) & ((1 << nbits) - 1)
        return token, nbits, bits

    def decode(self, token: int, read_bits) -> int:
        """read_bits: callable(nbits)->int. Mirrors ReadHybridUintConfig
        (dec_ans.h:229-260)."""
        if token < self.split_token:
            return token
        msb, lsb = self.msb_in_token, self.lsb_in_token
        nbits = (self.split_exponent - (msb + lsb)
                 + ((token - self.split_token) >> (msb + lsb)))
        nbits &= 31
        low = token & ((1 << lsb) - 1)
        token >>= lsb
        bits = read_bits(nbits)
        return ((((1 << msb) | (token & ((1 << msb) - 1))) << nbits | bits)
                << lsb) | low

    # ---- vectorized (NumPy) versions for bulk tokenization
    def encode_array(self, values: np.ndarray):
        """values: uint32 array -> (tokens, nbits, bits) arrays."""
        values = np.ascontiguousarray(values).astype(np.int64, copy=False)
        small = values < self.split_token
        safe = np.maximum(values, self.split_token)
        if safe.size and int(safe.max()) < (1 << 52):
            # exact floor(log2) from the float64 exponent field (integers
            # below 2^52 convert exactly)
            n = (safe.astype(np.float64).view(np.int64) >> 52) - 1023
        else:
            n = np.floor(np.log2(safe.astype(np.float64))).astype(np.int64)
            # correct potential float rounding at powers of two
            n = np.where((np.int64(1) << n) > safe, n - 1, n)
            n = np.where(((np.int64(1) << (n + 1)) <= safe), n + 1, n)
        m = safe - (np.int64(1) << n)
        msb, lsb = self.msb_in_token, self.lsb_in_token
        token_big = (self.split_token
                     + ((n - self.split_exponent) << (msb + lsb))
                     + ((m >> (n - msb)) << lsb)
                     + (m & ((1 << lsb) - 1)))
        nbits_big = n - msb - lsb
        bits_big = (safe >> lsb) & ((np.int64(1) << nbits_big) - 1)
        tokens = np.where(small, values, token_big)
        nbits = np.where(small, 0, nbits_big)
        bits = np.where(small, 0, bits_big)
        if nbits.size and int(nbits.max()) > 31:
            # > 31 extra bits cannot ride the 32-bit bits lane (the
            # writers and both native decoders cap reads at 31 bits);
            # silent truncation here would desync the stream
            from ..base.status import JXLError

            raise JXLError("hybrid-uint value needs > 31 extra bits")
        return (tokens.astype(np.uint32), nbits.astype(np.uint8),
                bits.astype(np.uint32))


# Default config used by the reference for most token streams.
DEFAULT_UINT_CONFIG = HybridUintConfig(4, 2, 0)
# Config for Lehmer permutations / coeff orders (coeff_order.cc:29).
PERMUTATION_UINT_CONFIG = HybridUintConfig(0, 0, 0)
