"""Table of contents: per-section byte sizes + optional permutation.

Mirrors lib/jxl/toc.cc (read) and lib/jxl/enc_toc.cc (write). The optional
permutation is entropy-coded (kPermutationContexts ANS streams over Lehmer
codes, coeff_order.cc:34-77); those hooks live in libjxl_tpu.entropy.permutation
and are imported lazily to keep io/ below entropy/ in the layer order.
"""

from __future__ import annotations

from ..base.status import JXLError, NotEnoughBytes
from .bits import BitReader, BitWriter
from .fields import Bits, BitsOffset, U32Enc, u32_read, u32_write

# kTocDist (toc.h:25)
TOC_DIST = U32Enc(Bits(10), BitsOffset(14, 1024), BitsOffset(22, 17408),
                  BitsOffset(30, 4211712))


def read_toc(num_entries: int, reader: BitReader):
    """Returns (sizes, permutation or None). toc.cc:23-68."""
    if num_entries > 65536:
        raise JXLError("too many toc entries")
    if num_entries == 0:
        raise JXLError("empty TOC")
    permutation = None
    if reader.read_bits(1) == 1:
        raise JXLError("a permuted TOC: not in this copy")
    reader.jump_to_byte_boundary()
    sizes = [u32_read(TOC_DIST, reader) for _ in range(num_entries)]
    reader.jump_to_byte_boundary()
    if not reader.all_reads_within_bounds():
        raise NotEnoughBytes("truncated TOC")
    return sizes, permutation


def read_group_offsets(num_entries: int, reader: BitReader):
    """Returns (offsets, sizes, total_size) with permutation applied
    (toc.cc:70-119)."""
    sizes, permutation = read_toc(num_entries, reader)
    offsets = []
    off = 0
    for s in sizes:
        offsets.append(off)
        off += s
    total = off
    if permutation is not None:
        offsets = [offsets[i] for i in permutation]
        sizes = [sizes[i] for i in permutation]
    return offsets, sizes, total


def write_group_offsets(group_sizes, permutation, writer: BitWriter) -> None:
    """group_sizes: byte sizes in permuted (stream) order; permutation maps
    stream position -> natural section index (enc_toc.cc:19-46)."""
    with writer.layer("toc"):
        if permutation:
            raise JXLError("a permuted TOC: not in this copy")
        writer.write(1, 0)
        writer.zero_pad_to_byte()
        for size in group_sizes:
            u32_write(TOC_DIST, size, writer)
        writer.zero_pad_to_byte()
