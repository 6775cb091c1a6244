"""LSB-first bit reader/writer for the JPEG XL codestream.

Semantics match the reference BitReader (lib/jxl/dec_bit_reader.h:29) and
BitWriter (lib/jxl/enc_bit_writer.h:31): bits are packed little-endian,
least-significant bit of each byte first.  These host-side classes serve
header/bundle parsing; bulk entropy decode uses the vectorized readers in
``libjxl_tpu.entropy``.
"""

from __future__ import annotations

from ..base.status import JXLError, NotEnoughBytes


class BitReader:
    """Suspension-safe LSB-first bit reader.

    Reads past the end of the buffer return zero bits and set an
    out-of-bounds flag instead of raising immediately, mirroring
    BitReader::AllReadsWithinBounds (dec_bit_reader.h:201-246) so header
    parsers can detect truncation after the fact.
    """

    __slots__ = ("data", "pos", "buf", "bits_in_buf", "_oob")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # next byte to refill from
        self.buf = 0
        self.bits_in_buf = 0
        self._oob = False

    def _refill(self) -> None:
        data, pos = self.data, self.pos
        n = len(data)
        while self.bits_in_buf <= 56:
            if pos < n:
                self.buf |= data[pos] << self.bits_in_buf
            # else: virtual zero-padding beyond the end (detected via
            # total_bits_consumed > len(data)*8 in all_reads_within_bounds)
            pos += 1
            self.bits_in_buf += 8
        self.pos = pos

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        if n > 32:
            lo = self.read_bits(32)
            hi = self.read_bits(n - 32)
            return lo | (hi << 32)
        if self.bits_in_buf < n:
            self._refill()
        val = self.buf & ((1 << n) - 1)
        self.buf >>= n
        self.bits_in_buf -= n
        return val

    def peek_bits(self, n: int) -> int:
        if self.bits_in_buf < n:
            self._refill()
        return self.buf & ((1 << n) - 1)

    def skip_bits(self, n: int) -> None:
        """O(1) skip (may be large: section/extension skipping). Skipping
        past the end only moves the virtual position; bounds violations
        surface via all_reads_within_bounds, like BitReader::SkipBits."""
        take = min(n, self.bits_in_buf)
        self.buf >>= take
        self.bits_in_buf -= take
        n -= take
        if n == 0:
            return
        # buffer is empty; jump whole bytes, then read leftover bits
        self.pos += n // 8
        n %= 8
        if n:
            self.read_bits(n)

    def total_bits_consumed(self) -> int:
        return self.pos * 8 - self.bits_in_buf

    def all_reads_within_bounds(self) -> bool:
        return self.total_bits_consumed() <= len(self.data) * 8

    def jump_to_byte_boundary(self) -> None:
        rem = self.total_bits_consumed() % 8
        if rem:
            pad = self.read_bits(8 - rem)
            if pad != 0:
                raise JXLError("nonzero padding at byte boundary")

    def seek_bits(self, bitpos: int) -> None:
        """Reposition to an absolute bit offset (used after native decode)."""
        self.pos = bitpos // 8
        self.buf = 0
        self.bits_in_buf = 0
        if bitpos % 8:
            self.read_bits(bitpos % 8)

    def close(self) -> None:
        if not self.all_reads_within_bounds():
            raise NotEnoughBytes(
                f"read {self.total_bits_consumed()} bits from "
                f"{len(self.data) * 8}-bit buffer"
            )


class BitWriter:
    """Append-only LSB-first bit writer (enc_bit_writer.h:31).

    Supports per-layer bit accounting like the reference AuxOut
    (enc_aux_out.h): pass ``layer=`` to ``write`` calls or use
    ``with writer.layer(name):`` blocks; totals land in ``layer_bits``.
    """

    __slots__ = ("_buf", "_bits", "_nbits", "layer_bits", "_layer_stack")

    def __init__(self):
        self._buf = bytearray()
        self._bits = 0
        self._nbits = 0
        self.layer_bits: dict = {}
        self._layer_stack: list = []

    def write(self, n: int, value: int) -> None:
        if value >> n:
            raise JXLError(f"value {value} does not fit in {n} bits")
        self._bits |= value << self._nbits
        self._nbits += n
        while self._nbits >= 8:
            self._buf.append(self._bits & 0xFF)
            self._bits >>= 8
            self._nbits -= 8
        if self._layer_stack:
            self.layer_bits[self._layer_stack[-1]] = (
                self.layer_bits.get(self._layer_stack[-1], 0) + n
            )

    def layer(self, name: str):
        writer = self

        class _Layer:
            def __enter__(self):
                writer._layer_stack.append(name)

            def __exit__(self, *exc):
                writer._layer_stack.pop()

        return _Layer()

    def zero_pad_to_byte(self) -> None:
        if self._nbits:
            self.write(8 - self._nbits, 0)

    def append_bytes(self, data: bytes) -> None:
        """Append byte-aligned data (writer must be at a byte boundary)."""
        if self._nbits:
            raise JXLError("append_bytes requires byte alignment")
        self._buf.extend(data)

    def append_raw_bits(self, data: bytes, nbits: int) -> None:
        """Append `nbits` LSB-first bits packed in `data` (bulk, O(n) in C
        via int<->bytes conversions; used by the native ANS writer)."""
        full, rem = divmod(nbits, 8)
        if full:
            big = int.from_bytes(data[:full], "little")
            big = (big << self._nbits) | self._bits
            totbits = self._nbits + full * 8
            nbytes = totbits // 8
            self._buf.extend(
                (big & ((1 << (nbytes * 8)) - 1)).to_bytes(nbytes, "little"))
            self._bits = big >> (nbytes * 8)
            self._nbits = totbits % 8
        if rem:
            self.write(rem, data[full] & ((1 << rem) - 1))
        if self._layer_stack and full:
            self.layer_bits[self._layer_stack[-1]] = (
                self.layer_bits.get(self._layer_stack[-1], 0) + full * 8)

    def append_bits_from(self, other: "BitWriter") -> None:
        """Append another writer's bits without alignment
        (BitWriter::AppendUnaligned analog)."""
        for byte in other._buf:
            self.write(8, byte)
        if other._nbits:
            self.write(other._nbits, other._bits)

    def bits_written(self) -> int:
        return len(self._buf) * 8 + self._nbits

    def get_bytes(self) -> bytes:
        self.zero_pad_to_byte()
        return bytes(self._buf)
