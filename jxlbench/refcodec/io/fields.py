"""Declarative header serialization ("bundles").

Mirrors the reference Fields/Visitor double-dispatch (lib/jxl/fields.h:58-193,
fields.cc): every header struct implements ``visit_fields(v)``; the same code
path reads, writes, measures, and default-initializes.

Integer coders:
- BitsCoder: fixed-width raw bits.
- U32Coder: 2-bit selector choosing one of four distributions, each either a
  direct value or (extra-bits, offset)  (fields.h:42-70).
- U64Coder: 2-bit selector; 0 | 1+Bits(4) | 17+Bits(8) | 12-bit head plus
  8-bit continuation groups and a final 4-bit group (fields.cc:549-575).
- F16Coder: IEEE binary16, NaN/Inf forbidden (fields.cc:605-629).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

from ..base.status import JXLError
from .bits import BitReader, BitWriter


# ---------------------------------------------------------------- U32 encodings
@dataclass(frozen=True)
class Val:
    value: int


@dataclass(frozen=True)
class BitsOffset:
    bits: int
    offset: int


def Bits(n: int) -> BitsOffset:
    return BitsOffset(n, 0)


@dataclass(frozen=True)
class U32Enc:
    d0: object
    d1: object
    d2: object
    d3: object

    def dist(self, i: int):
        return (self.d0, self.d1, self.d2, self.d3)[i]


def u32_read(enc: U32Enc, r: BitReader) -> int:
    d = enc.dist(r.read_bits(2))
    if isinstance(d, Val):
        return d.value
    return d.offset + r.read_bits(d.bits)


def u32_choose_selector(enc: U32Enc, value: int):
    """Smallest representation wins; ties broken by lowest selector
    (U32Coder::ChooseSelector, fields.cc)."""
    best = None
    for sel in range(4):
        d = enc.dist(sel)
        if isinstance(d, Val):
            if d.value == value:
                total = 2
            else:
                continue
        else:
            if value < d.offset or value - d.offset >= (1 << d.bits):
                continue
            total = 2 + d.bits
        if best is None or total < best[1]:
            best = (sel, total)
    if best is None:
        raise JXLError(f"value {value} not encodable by {enc}")
    return best


def u32_write(enc: U32Enc, value: int, w: BitWriter) -> None:
    sel, _ = u32_choose_selector(enc, value)
    w.write(2, sel)
    d = enc.dist(sel)
    if isinstance(d, BitsOffset):
        w.write(d.bits, value - d.offset)


def u64_read(r: BitReader) -> int:
    sel = r.read_bits(2)
    if sel == 0:
        return 0
    if sel == 1:
        return 1 + r.read_bits(4)
    if sel == 2:
        return 17 + r.read_bits(8)
    result = r.read_bits(12)
    shift = 12
    while r.read_bits(1):
        if shift == 60:
            result |= r.read_bits(4) << shift
            break
        result |= r.read_bits(8) << shift
        shift += 8
    return result


def u64_write(value: int, w: BitWriter) -> None:
    if value == 0:
        w.write(2, 0)
    elif value <= 16:
        w.write(2, 1)
        w.write(4, value - 1)
    elif value <= 272:
        w.write(2, 2)
        w.write(8, value - 17)
    else:
        w.write(2, 3)
        w.write(12, value & 0xFFF)
        value >>= 12
        shift = 12
        while value > 0:
            w.write(1, 1)  # continuation bit
            if shift == 60:
                # final 4-bit group; decoder stops after it, no stop bit
                w.write(4, value & 0xF)
                return
            w.write(8, value & 0xFF)
            value >>= 8
            shift += 8
        w.write(1, 0)  # stop bit


def f16_read(r: BitReader) -> float:
    bits16 = r.read_bits(16)
    sign = bits16 >> 15
    biased_exp = (bits16 >> 10) & 0x1F
    mantissa = bits16 & 0x3FF
    if biased_exp == 31:
        raise JXLError("F16 infinity or NaN are not supported")
    if biased_exp == 0:
        value = (1.0 / 16384) * (mantissa * (1.0 / 1024))
    else:
        value = struct.unpack(
            "<f",
            struct.pack(
                "<I", (sign << 31) | ((biased_exp + 112) << 23) | (mantissa << 13)
            ),
        )[0]
        return value
    return -value if sign else value


def f16_write(value: float, w: BitWriter) -> None:
    if math.isnan(value) or math.isinf(value) or abs(value) > 65504.0:
        raise JXLError("value not representable as F16")
    bits16 = struct.unpack("<H", struct.pack("<e", value))[0]
    w.write(16, bits16)


def pack_signed(v: int) -> int:
    """Zigzag map int -> uint (pack_signed.h:18-27)."""
    return (v << 1) if v >= 0 else (-v * 2 - 1)


def unpack_signed(u: int) -> int:
    return (u >> 1) if (u & 1) == 0 else -((u + 1) >> 1)


class Visitor:
    """Base visitor; subclasses implement the *_val primitives.

    Two API levels:
    - value-based: ``v.u32_val(value, enc, default) -> new_value`` — the core;
      works for loops over list fields.
    - attribute-based convenience: ``v.u32(obj, enc, default, 'attr')`` reads
      obj.attr, visits it, stores the result back.
    One visit_fields body serves read/write/all-default/init, mirroring the
    reference double dispatch (fields.h:101-188).
    """

    def is_reading(self) -> bool:
        return False

    # ---- value-based primitives (override in subclasses)
    def bits_val(self, value: int, n: int, default: int) -> int:
        raise NotImplementedError

    def u32_val(self, value: int, enc: U32Enc, default: int) -> int:
        raise NotImplementedError

    def u64_val(self, value: int, default: int) -> int:
        raise NotImplementedError

    def bool_val(self, value: bool, default: bool) -> bool:
        raise NotImplementedError

    def f16_val(self, value: float, default: float) -> float:
        raise NotImplementedError

    def enum_val(self, value: int, default: int) -> int:
        return self.u32_val(value, _ENUM_ENC, default)

    # ---- attribute-based convenience wrappers
    def _visit_attr(self, obj, attr, fn):
        v = fn(getattr(obj, attr, None))
        setattr(obj, attr, v)
        return v

    def bits(self, obj, n, default, attr):
        return self._visit_attr(obj, attr, lambda x: self.bits_val(x, n, default))

    def u32(self, obj, enc, default, attr):
        return self._visit_attr(obj, attr, lambda x: self.u32_val(x, enc, default))

    def u64(self, obj, default, attr):
        return self._visit_attr(obj, attr, lambda x: self.u64_val(x, default))

    def bool_(self, obj, default, attr):
        return self._visit_attr(obj, attr, lambda x: self.bool_val(x, default))

    def f16(self, obj, default, attr):
        return self._visit_attr(obj, attr, lambda x: self.f16_val(x, default))

    def enum(self, obj, default, attr):
        return self._visit_attr(obj, attr, lambda x: self.enum_val(x, default))

    def name_string(self, obj, attr="name"):
        """Length-prefixed byte string (frame_header.h:35-50)."""
        name = getattr(obj, attr, "") or ""
        raw = name.encode("utf-8")
        n = self.u32_val(
            len(raw), U32Enc(Val(0), Bits(4), BitsOffset(5, 16), BitsOffset(10, 48)), 0
        )
        if self.is_reading():
            chars = bytes(self.bits_val(0, 8, 0) for _ in range(n))
            setattr(obj, attr, chars.decode("utf-8", errors="replace"))
        else:
            for b in raw:
                self.bits_val(b, 8, 0)
        return getattr(obj, attr)

    # ---- structure
    def conditional(self, cond: bool) -> bool:
        return bool(cond)

    def all_default(self, obj) -> bool:
        """Visit the all_default bool; returns True iff remaining fields are
        to be skipped."""
        raise NotImplementedError

    def visit_nested(self, obj, nested, attr: str = None):
        nested.visit_fields(self)
        return nested

    def begin_extensions(self, obj) -> int:
        return self.u64(obj, 0, "extensions")

    def end_extensions(self) -> None:
        pass


_ENUM_ENC = U32Enc(Val(0), Val(1), BitsOffset(4, 2), BitsOffset(6, 18))


class SetDefaultVisitor(Visitor):
    def bits_val(self, value, n, default):
        return default

    def u32_val(self, value, enc, default):
        return default

    def u64_val(self, value, default):
        return default

    def bool_val(self, value, default):
        return default

    def f16_val(self, value, default):
        return default

    def conditional(self, cond):
        return True  # initialize every conditional field

    def all_default(self, obj):
        obj.all_default = True
        return False  # keep visiting to initialize

    def visit_nested(self, obj, nested, attr=None):
        nested.set_default()
        return nested

    def name_string(self, obj, attr="name"):
        setattr(obj, attr, "")
        return ""


class AllDefaultVisitor(Visitor):
    def __init__(self):
        self.result = True

    def bits_val(self, value, n, default):
        self.result &= value == default
        return value

    def u32_val(self, value, enc, default):
        self.result &= value == default
        return value

    def u64_val(self, value, default):
        self.result &= value == default
        return value

    def bool_val(self, value, default):
        self.result &= value == default
        return value

    def f16_val(self, value, default):
        self.result &= abs(value - default) < 1e-6
        return value

    def all_default(self, obj):
        return False  # skip the all_default field itself; keep checking

    def name_string(self, obj, attr="name"):
        self.result &= not getattr(obj, attr, "")
        return getattr(obj, attr, "")


class ReadVisitor(Visitor):
    def __init__(self, reader: BitReader):
        self.r = reader
        self._ext_bits = {}
        self._pos_after_ext_size = 0
        self._total_ext_bits = 0

    def is_reading(self):
        return True

    def bits_val(self, value, n, default):
        return self.r.read_bits(n)

    def u32_val(self, value, enc, default):
        return u32_read(enc, self.r)

    def u64_val(self, value, default):
        return u64_read(self.r)

    def bool_val(self, value, default):
        return bool(self.r.read_bits(1))

    def f16_val(self, value, default):
        return f16_read(self.r)

    def all_default(self, obj):
        ad = bool(self.r.read_bits(1))
        if ad:
            obj.set_default()
        obj.all_default = ad
        return ad

    def begin_extensions(self, obj) -> int:
        ext = self.u64(obj, 0, "extensions")
        if ext:
            rem = ext
            while rem:
                idx = (rem & -rem).bit_length() - 1
                self._ext_bits[idx] = u64_read(self.r)
                self._total_ext_bits += self._ext_bits[idx]
                rem &= rem - 1
            self._pos_after_ext_size = self.r.total_bits_consumed()
        return ext

    def end_extensions(self):
        if self._pos_after_ext_size == 0:
            return
        end = self._pos_after_ext_size + self._total_ext_bits
        skip = end - self.r.total_bits_consumed()
        if skip < 0:
            raise JXLError("read more extension bits than signaled")
        self.r.skip_bits(skip)
        if not self.r.all_reads_within_bounds():
            from ..base.status import NotEnoughBytes

            raise NotEnoughBytes("extension bits beyond end of stream")


class WriteVisitor(Visitor):
    def __init__(self, writer: BitWriter):
        self.w = writer

    def bits_val(self, value, n, default):
        self.w.write(n, value)
        return value

    def u32_val(self, value, enc, default):
        u32_write(enc, value, self.w)
        return value

    def u64_val(self, value, default):
        u64_write(value, self.w)
        return value

    def bool_val(self, value, default):
        self.w.write(1, 1 if value else 0)
        return value

    def f16_val(self, value, default):
        f16_write(value, self.w)
        return value

    def all_default(self, obj):
        is_default = bundle_all_default(obj)
        self.w.write(1, 1 if is_default else 0)
        return is_default

    def begin_extensions(self, obj) -> int:
        ext = getattr(obj, "extensions", 0)
        u64_write(ext, self.w)
        if ext:
            raise JXLError("writing extensions is not supported")
        return ext


class Bundle:
    """Base class for all header bundles."""

    def __init__(self, **kwargs):
        self.set_default()
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"{type(self).__name__} has no field {k}")
            setattr(self, k, v)

    def visit_fields(self, v: Visitor) -> None:
        raise NotImplementedError

    def set_default(self) -> None:
        self.visit_fields(SetDefaultVisitor())

    def read(self, r: BitReader) -> "Bundle":
        rv = ReadVisitor(r)
        self.visit_fields(rv)
        rv.end_extensions()
        return self

    def write(self, w: BitWriter) -> None:
        self.visit_fields(WriteVisitor(w))

    def __repr__(self):
        fields = {
            k: v for k, v in self.__dict__.items() if not k.startswith("_")
        }
        return f"{type(self).__name__}({fields})"


def bundle_all_default(obj) -> bool:
    v = AllDefaultVisitor()
    obj.visit_fields(v)
    return v.result


def bundle_read(cls, r: BitReader, **ctor_kwargs):
    obj = cls(**ctor_kwargs)
    return obj.read(r)
