"""Modular transforms: RCT (15x6 lifting color transforms), Squeeze
(nonlinear Haar with smooth tendency), Palette (incl. implicit/delta).

Mirrors modular/transform/{transform.h,rct.cc,squeeze.{h,cc},
enc_squeeze.cc,palette.{h,cc},enc_rct.cc}. All pixel math is vectorized
NumPy on int64 intermediates (the reference uses pixel_type_w = int64).
"""

from __future__ import annotations

import numpy as np

from ..base.status import JXLError
from ..io.fields import Bits, BitsOffset, Bundle, U32Enc, Val
from .image import Channel, ModularImage
from .predict import P_ZERO, P_WEIGHTED, WeightedState, predict_one, neighbors

T_RCT, T_PALETTE, T_SQUEEZE, T_INVALID = 0, 1, 2, 3

_BEGIN_C_ENC = U32Enc(Bits(3), BitsOffset(6, 8), BitsOffset(10, 72),
                      BitsOffset(13, 1096))


class SqueezeParams(Bundle):
    """transform.h:38-55."""

    def visit_fields(self, v):
        v.bool_(self, False, "horizontal")
        v.bool_(self, False, "in_place")
        v.u32(self, _BEGIN_C_ENC, 0, "begin_c")
        v.u32(self, U32Enc(Val(1), Val(2), Val(3), BitsOffset(4, 4)), 2, "num_c")


class Transform(Bundle):
    """transform.h:57-137."""

    def visit_fields(self, v):
        v.u32(self, U32Enc(Val(T_RCT), Val(T_PALETTE), Val(T_SQUEEZE),
                           Val(T_INVALID)), T_RCT, "id")
        if self.id == T_INVALID:
            raise JXLError("invalid transform id")
        if v.conditional(self.id in (T_RCT, T_PALETTE)):
            v.u32(self, _BEGIN_C_ENC, 0, "begin_c")
        if v.conditional(self.id == T_RCT):
            v.u32(self, U32Enc(Val(6), Bits(2), BitsOffset(4, 2),
                               BitsOffset(6, 10)), 6, "rct_type")
            if self.rct_type >= 42:
                raise JXLError("invalid RCT type")
        if v.conditional(self.id == T_PALETTE):
            v.u32(self, U32Enc(Val(1), Val(3), Val(4), BitsOffset(13, 1)),
                  3, "num_c")
            v.u32(self, U32Enc(BitsOffset(8, 0), BitsOffset(10, 256),
                               BitsOffset(12, 1280), BitsOffset(16, 5376)),
                  256, "nb_colors")
            v.u32(self, U32Enc(Val(0), BitsOffset(8, 1), BitsOffset(10, 257),
                               BitsOffset(16, 1281)), 0, "nb_deltas")
            v.bits(self, 4, P_ZERO, "predictor")
            if self.predictor >= 14:
                raise JXLError("invalid palette predictor")
        if v.conditional(self.id == T_SQUEEZE):
            n = len(self.squeezes) if not v.is_reading() else 0
            n = v.u32_val(n, U32Enc(Val(0), BitsOffset(4, 1), BitsOffset(6, 9),
                                    BitsOffset(8, 41)), 0)
            if v.is_reading():
                self.squeezes = [SqueezeParams() for _ in range(n)]
            for sq in self.squeezes:
                v.visit_nested(self, sq)

    def set_default(self):
        self.id = T_RCT
        self.begin_c = 0
        self.rct_type = 6
        self.num_c = 3
        self.nb_colors = 256
        self.nb_deltas = 0
        self.predictor = P_ZERO
        self.squeezes = []

    # ---- dispatch (transform.cc:25-60)
    def meta_apply(self, image: ModularImage):
        if self.id == T_SQUEEZE:
            meta_squeeze(image, self)
        elif self.id == T_PALETTE:
            meta_palette(image, self.begin_c, self.begin_c + self.num_c - 1,
                         self.nb_colors, self.nb_deltas)
        elif self.id == T_RCT:
            check_equal_channels(image, self.begin_c, self.begin_c + 2)

    def inverse(self, image: ModularImage, wp_header):
        if self.id == T_RCT:
            inv_rct(image, self.begin_c, self.rct_type)
        elif self.id == T_SQUEEZE:
            inv_squeeze(image, self.squeezes)
        elif self.id == T_PALETTE:
            inv_palette(image, self.begin_c, self.nb_colors, self.nb_deltas,
                        self.predictor, wp_header)


def check_equal_channels(image: ModularImage, c1: int, c2: int) -> None:
    if c1 > c2 or c2 >= len(image.channel):
        raise JXLError("channel range out of bounds")
    if c1 < image.nb_meta_channels or (c2 < image.nb_meta_channels
                                       and c2 >= c1):
        if c1 < image.nb_meta_channels and c2 >= image.nb_meta_channels:
            raise JXLError("invalid transform: mix of meta/nonmeta")
    ch0 = image.channel[c1]
    for c in range(c1 + 1, c2 + 1):
        ch = image.channel[c]
        if ch.w != ch0.w or ch.h != ch0.h:
            raise JXLError("transform requires equal-size channels")


# ------------------------------------------------------------------------ RCT
def _rct_perm_indices(permutation: int):
    """rct.cc:107-117: output channel index for each input slot."""
    return (permutation % 3,
            (permutation + 1 + permutation // 3) % 3,
            (permutation + 2 - permutation // 3) % 3)


def inv_rct(image: ModularImage, begin_c: int, rct_type: int) -> None:
    """rct.cc:88-139."""
    check_equal_channels(image, begin_c, begin_c + 2)
    m = begin_c
    if rct_type == 0:
        return
    permutation = rct_type // 7
    custom = rct_type % 7
    in_ch = [image.channel[m + i].data.astype(np.int64) for i in range(3)]
    i0, i1, i2 = _rct_perm_indices(permutation)
    if custom == 0:
        datas = [image.channel[m + i].data for i in range(3)]
        image.channel[m + i0].data = datas[0]
        image.channel[m + i1].data = datas[1]
        image.channel[m + i2].data = datas[2]
        return
    if custom == 6:  # YCoCg
        y, co, cg = in_ch
        tmp = y - (cg >> 1)
        g = cg + tmp
        b = tmp - (co >> 1)
        r = b + co
        out = (r, g, b)
    else:
        second = custom >> 1
        third = custom & 1
        first, snd, thd = in_ch
        if third:
            thd = thd + first
        if second == 1:
            snd = snd + first
        elif second == 2:
            snd = snd + ((first + thd) >> 1)
        out = (first, snd, thd)
    image.channel[m + i0].data = out[0].astype(np.int32)
    image.channel[m + i1].data = out[1].astype(np.int32)
    image.channel[m + i2].data = out[2].astype(np.int32)


def fwd_rct(image: ModularImage, begin_c: int, rct_type: int) -> None:
    """Forward RCT (enc_rct.cc): inverse of inv_rct."""
    check_equal_channels(image, begin_c, begin_c + 2)
    m = begin_c
    if rct_type == 0:
        return
    permutation = rct_type // 7
    custom = rct_type % 7
    i0, i1, i2 = _rct_perm_indices(permutation)
    src = [image.channel[m + i].data.astype(np.int64) for i in (i0, i1, i2)]
    if custom == 0:
        for i, d in enumerate(src):
            image.channel[m + i].data = d.astype(np.int32)
        return
    if custom == 6:  # RGB -> YCoCg
        r, g, b = src
        co = r - b
        tmp = b + (co >> 1)
        cg = g - tmp
        y = tmp + (cg >> 1)
        out = (y, co, cg)
    else:
        second = custom >> 1
        third = custom & 1
        first, snd, thd = src
        if second == 1:
            snd = snd - first
        elif second == 2:
            snd = snd - ((first + thd) >> 1)
        if third:
            thd = thd - first
        out = (first, snd, thd)
    for i, d in enumerate(out):
        image.channel[m + i].data = d.astype(np.int32)


# -------------------------------------------------------------------- Squeeze
def smooth_tendency(b, a, n):
    """SmoothTendency (squeeze.h:60-77), vectorized; all int64 arrays."""
    b = b.astype(np.int64)
    a = a.astype(np.int64)
    n = n.astype(np.int64)
    # descending case
    diff_d = (4 * b - 3 * n - a + 6) // 12
    diff_d = np.where(diff_d - (diff_d & 1) > 2 * (b - a), 2 * (b - a) + 1, diff_d)
    diff_d = np.where(diff_d + (diff_d & 1) > 2 * (a - n), 2 * (a - n), diff_d)
    # ascending case (C++ / truncates toward zero; operand may be negative)
    num_a = 4 * b - 3 * n - a - 6
    diff_a = -((-num_a) // 12)  # trunc toward zero for negative numerators
    diff_a = np.where(num_a >= 0, num_a // 12, diff_a)
    diff_a = np.where(diff_a + (diff_a & 1) < 2 * (b - a), 2 * (b - a) - 1, diff_a)
    diff_a = np.where(diff_a - (diff_a & 1) < 2 * (a - n), 2 * (a - n), diff_a)
    desc = (b >= a) & (a >= n)
    asc = (b <= a) & (a <= n)
    return np.where(desc, diff_d, np.where(asc, diff_a, 0))


def _trunc_div2(v):
    """C++ v/2 (truncation toward zero) for int arrays."""
    return np.where(v >= 0, v // 2, -((-v) // 2))


def default_squeeze_parameters(image: ModularImage):
    """squeeze.cc:364-417."""
    params = []
    nbc = len(image.channel) - image.nb_meta_channels
    first = image.nb_meta_channels
    w = image.channel[first].w
    h = image.channel[first].h
    MAX_FIRST = 8
    wide = w > h
    if (nbc > 2 and image.channel[first + 1].w == w
            and image.channel[first + 1].h == h):
        p = SqueezeParams()
        p.horizontal, p.in_place = True, False
        p.begin_c, p.num_c = first + 1, 2
        params.append(p)
        p2 = SqueezeParams()
        p2.horizontal, p2.in_place = False, False
        p2.begin_c, p2.num_c = first + 1, 2
        params.append(p2)

    def add(horizontal):
        p = SqueezeParams()
        p.horizontal = horizontal
        p.in_place = True
        p.begin_c = first
        p.num_c = nbc
        params.append(p)

    if not wide and h > MAX_FIRST:
        add(False)
        h = (h + 1) // 2
    while w > MAX_FIRST or h > MAX_FIRST:
        if w > MAX_FIRST:
            add(True)
            w = (w + 1) // 2
        if h > MAX_FIRST:
            add(False)
            h = (h + 1) // 2
    return params


def meta_squeeze(image: ModularImage, transform: Transform) -> None:
    """squeeze.cc:433-493: shrink channel dims and insert residual
    placeholders."""
    if not transform.squeezes:
        transform.squeezes = default_squeeze_parameters(image)
    for p in transform.squeezes:
        begin, end = p.begin_c, p.begin_c + p.num_c - 1
        if end >= len(image.channel) or begin > end:
            raise JXLError("invalid squeeze channel range")
        if begin < image.nb_meta_channels:
            if end >= image.nb_meta_channels:
                raise JXLError("squeeze mixes meta/nonmeta")
            if not p.in_place:
                raise JXLError("meta squeeze must be in place")
            image.nb_meta_channels += p.num_c
        offset = end + 1 if p.in_place else len(image.channel)
        for c in range(begin, end + 1):
            ch = image.channel[c]
            if ch.w == 0 or ch.h == 0:
                raise JXLError("squeezing empty channel")
            if p.horizontal:
                neww = (ch.w + 1) // 2
                rw = ch.w - neww
                ph = Channel(rw, ch.h, ch.hshift + 1, ch.vshift)
                ch.data = ch.data[:, :neww].copy()
                ch.hshift += 1
            else:
                newh = (ch.h + 1) // 2
                rh = ch.h - newh
                ph = Channel(ch.w, rh, ch.hshift, ch.vshift + 1)
                ch.data = ch.data[:newh, :].copy()
                ch.vshift += 1
            image.channel.insert(offset + (c - begin), ph)


def fwd_h_squeeze(image: ModularImage, c: int, rc: int) -> None:
    """enc_squeeze.cc:21-60 (vectorized over rows)."""
    chin = image.channel[c]
    data = chin.data.astype(np.int64)
    h, w = data.shape
    neww = (w + 1) // 2
    A = data[:, 0:2 * (w // 2):2]
    B = data[:, 1::2]
    avg = (A + B + (A > B)) >> 1
    out = np.zeros((h, neww), dtype=np.int64)
    out[:, :w // 2] = avg
    if w & 1:
        out[:, -1] = data[:, -1]
    diff = A - B
    # next_avg: out[:, x+1] if x+1 < neww else (odd tail uses raw pixel)
    next_avg = np.empty_like(avg)
    if w // 2 > 0:
        next_avg[:, :-1] = out[:, 1:w // 2]
        next_avg[:, -1] = out[:, w // 2] if (w & 1) else avg[:, -1]
    left = np.empty_like(avg)
    left[:, 0] = avg[:, 0]
    left[:, 1:] = B[:, :-1]
    tendency = smooth_tendency(left, avg, next_avg)
    res = diff - tendency
    image.channel[c] = Channel(neww, h, chin.hshift + 1, chin.vshift,
                               out.astype(np.int32))
    image.channel[rc] = Channel(w - neww, h, chin.hshift + 1, chin.vshift,
                                res.astype(np.int32))


def fwd_v_squeeze(image: ModularImage, c: int, rc: int) -> None:
    chin = image.channel[c]
    data = chin.data.astype(np.int64)
    h, w = data.shape
    newh = (h + 1) // 2
    A = data[0:2 * (h // 2):2, :]
    B = data[1::2, :]
    avg = (A + B + (A > B)) >> 1
    out = np.zeros((newh, w), dtype=np.int64)
    out[:h // 2, :] = avg
    if h & 1:
        out[-1, :] = data[-1, :]
    diff = A - B
    next_avg = np.empty_like(avg)
    if h // 2 > 0:
        next_avg[:-1, :] = out[1:h // 2, :]
        next_avg[-1, :] = out[h // 2, :] if (h & 1) else avg[-1, :]
    top = np.empty_like(avg)
    top[0, :] = avg[0, :]
    top[1:, :] = B[:-1, :]
    tendency = smooth_tendency(top, avg, next_avg)
    res = diff - tendency
    image.channel[c] = Channel(w, newh, chin.hshift, chin.vshift + 1,
                               out.astype(np.int32))
    image.channel[rc] = Channel(w, h - newh, chin.hshift, chin.vshift + 1,
                                res.astype(np.int32))


def fwd_squeeze(image: ModularImage, params) -> None:
    """enc_squeeze.cc:126-160: apply squeezes in order. Channel dims must
    already be as before meta_squeeze (call on the pristine image)."""
    for p in params:
        begin, end = p.begin_c, p.begin_c + p.num_c - 1
        offset = end + 1 if p.in_place else len(image.channel)
        if begin < image.nb_meta_channels:
            image.nb_meta_channels += p.num_c
        for c in range(begin, end + 1):
            rc = offset + (c - begin)
            image.channel.insert(rc, Channel(0, 0))
            if p.horizontal:
                fwd_h_squeeze(image, c, rc)
            else:
                fwd_v_squeeze(image, c, rc)


def inv_h_squeeze(image: ModularImage, c: int, rc: int) -> None:
    """squeeze.cc:104-216, vectorized per row-pair with sequential x.

    The x-dependence (left = previous output odd pixel) forces a serial
    column loop, but all rows process in parallel (NumPy columns)."""
    chin = image.channel[c]
    chres = image.channel[rc]
    if chres.w == 0:
        image.channel[c].hshift -= 1
        return
    h = chin.h
    w_out = chin.w + chres.w
    out = np.zeros((h, w_out), dtype=np.int64)
    avg_data = chin.data.astype(np.int64)
    res_data = chres.data.astype(np.int64)
    if chres.h != 0:
        prev_b = avg_data[:, 0]  # "left" for x=0 is avg
        for x in range(chres.w):
            avg = avg_data[:, x]
            next_avg = avg_data[:, x + 1] if x + 1 < chin.w else avg
            tendency = smooth_tendency(prev_b, avg, next_avg)
            diff = res_data[:, x] + tendency
            A = avg + _trunc_div2(diff)
            out[:, 2 * x] = A
            B = A - diff
            out[:, 2 * x + 1] = B
            prev_b = B
        if w_out & 1:
            out[:, -1] = avg_data[:, -1]
    image.channel[c] = Channel(w_out, h, chin.hshift - 1, chin.vshift,
                               out.astype(np.int32))


def inv_v_squeeze(image: ModularImage, c: int, rc: int) -> None:
    """squeeze.cc:218-306: serial in y, vectorized across x."""
    chin = image.channel[c]
    chres = image.channel[rc]
    if chres.h == 0:
        image.channel[c].vshift -= 1
        return
    w = chin.w
    h_out = chin.h + chres.h
    out = np.zeros((h_out, w), dtype=np.int64)
    avg_data = chin.data.astype(np.int64)
    res_data = chres.data.astype(np.int64)
    if chres.w != 0:
        for y in range(chres.h):
            avg = avg_data[y, :]
            next_avg = avg_data[y + 1, :] if y + 1 < chin.h else avg
            top = out[2 * y - 1, :] if y > 0 else avg
            tendency = smooth_tendency(top, avg, next_avg)
            diff = res_data[y, :] + tendency
            o = avg + _trunc_div2(diff)
            out[2 * y, :] = o
            out[2 * y + 1, :] = o - diff
        if h_out & 1:
            out[-1, :] = avg_data[-1, :]
    image.channel[c] = Channel(w, h_out, chin.hshift, chin.vshift - 1,
                               out.astype(np.int32))


def inv_squeeze(image: ModularImage, params) -> None:
    """squeeze.cc:308-348."""
    for p in reversed(params):
        begin, end = p.begin_c, p.begin_c + p.num_c - 1
        if p.in_place:
            offset = end + 1
        else:
            offset = len(image.channel) + begin - end - 1
        if begin < image.nb_meta_channels:
            image.nb_meta_channels -= p.num_c
        for c in range(begin, end + 1):
            rc = offset + c - begin
            if rc >= len(image.channel):
                raise JXLError("corrupted squeeze")
            if (image.channel[c].w < image.channel[rc].w
                    or image.channel[c].h < image.channel[rc].h):
                raise JXLError("corrupted squeeze")
            if p.horizontal:
                inv_h_squeeze(image, c, rc)
            else:
                inv_v_squeeze(image, c, rc)
        del image.channel[offset:offset + (end - begin + 1)]


# -------------------------------------------------------------------- Palette
_DELTA_PALETTE = np.array([
    [0, 0, 0], [4, 4, 4], [11, 0, 0], [0, 0, -13], [0, -12, 0],
    [-10, -10, -10], [-18, -18, -18], [-27, -27, -27], [-18, -18, 0],
    [0, 0, -32], [-32, 0, 0], [-37, -37, -37], [0, -32, -32], [24, 24, 45],
    [50, 50, 50], [-45, -24, -24], [-24, -45, -45], [0, -24, -24],
    [-34, -34, 0], [-24, 0, -24], [-45, -45, -24], [64, 64, 64],
    [-32, 0, -32], [0, -32, 0], [-32, 0, 32], [-24, -45, -24], [45, 24, 45],
    [24, -24, -45], [-45, -24, 24], [80, 80, 80], [64, 0, 0], [0, 0, -64],
    [0, -64, -64], [-24, -24, 45], [96, 96, 96], [64, 64, 0], [45, -24, -24],
    [34, -34, 0], [112, 112, 112], [24, -45, -45], [45, 45, -24],
    [0, -32, 32], [24, -24, 45], [0, 96, 96], [45, -24, 24], [24, -45, -24],
    [-24, -45, 24], [0, -64, 0], [96, 0, 0], [128, 128, 128], [64, 0, 64],
    [144, 144, 144], [96, 96, 0], [-36, -36, 36], [45, -24, -45],
    [45, -45, -24], [0, 0, -96], [0, 128, 128], [0, 96, 0], [45, 24, -45],
    [-128, 0, 0], [24, -45, 24], [-45, 24, -45], [64, 0, -64], [64, -64, -64],
    [96, 0, 96], [45, -45, 24], [24, 45, -45], [64, 64, -64], [128, 128, 0],
    [0, 0, -128], [-24, 45, -45]], dtype=np.int64)

_SMALL_CUBE = 4
_LARGE_CUBE = 5
_LARGE_CUBE_OFFSET = _SMALL_CUBE ** 3


def get_palette_value(palette: np.ndarray, index: int, c: int,
                      palette_size: int, bit_depth: int) -> int:
    """palette.h:54-140 (scalar version)."""
    if index < 0:
        if c >= 3:
            return 0
        idx = -(index + 1)
        idx %= 1 + 2 * (len(_DELTA_PALETTE) - 1)
        result = int(_DELTA_PALETTE[(idx + 1) >> 1][c]) * (-1 if (idx & 1) == 0 else 1)
        if bit_depth > 8:
            result *= 1 << (bit_depth - 8)
        return result
    if palette_size <= index < palette_size + _LARGE_CUBE_OFFSET:
        if c >= 3:
            return 0
        idx = index - palette_size
        idx >>= c * 2
        return (((idx % _SMALL_CUBE) * ((1 << bit_depth) - 1)) >> 2) \
            + (1 << max(0, bit_depth - 3))
    if index >= palette_size + _LARGE_CUBE_OFFSET:
        if c >= 3:
            return 0
        idx = index - palette_size - _LARGE_CUBE_OFFSET
        if c == 1:
            idx //= _LARGE_CUBE
        elif c == 2:
            idx //= _LARGE_CUBE * _LARGE_CUBE
        return ((idx % _LARGE_CUBE) * ((1 << bit_depth) - 1)) // (_LARGE_CUBE - 1)
    return int(palette[c][index])


def meta_palette(image: ModularImage, begin_c: int, end_c: int,
                 nb_colors: int, nb_deltas: int) -> None:
    """palette.cc:164-186."""
    check_equal_channels(image, begin_c, end_c)
    nb = end_c - begin_c + 1
    if begin_c >= image.nb_meta_channels:
        image.nb_meta_channels += 1
    else:
        if end_c >= image.nb_meta_channels:
            raise JXLError("palette mixes meta/nonmeta")
        image.nb_meta_channels += 2 - nb
    del image.channel[begin_c + 1:end_c + 1]
    pch = Channel(nb_colors + nb_deltas, nb, -1, -1)
    image.channel.insert(0, pch)


def inv_palette(image: ModularImage, begin_c: int, nb_colors: int,
                nb_deltas: int, predictor: int, wp_header) -> None:
    """palette.cc:15-161."""
    if image.nb_meta_channels < 1:
        raise JXLError("palette transform without palette")
    nb = image.channel[0].h
    c0 = begin_c + 1
    if c0 >= len(image.channel):
        raise JXLError("palette channel out of range")
    w = image.channel[c0].w
    h = image.channel[c0].h
    if nb < 1:
        raise JXLError("corrupted palette transform")
    for i in range(1, nb):
        image.channel.insert(
            c0 + 1, Channel(w, h, image.channel[c0].hshift,
                            image.channel[c0].vshift))
    palette = image.channel[0].data  # shape (nb, nb_colors+nb_deltas)
    palette_size = palette.shape[1]
    bit_depth = min(image.bitdepth, 24)
    indices = image.channel[c0].data.copy()
    if w == 0:
        pass
    elif nb_deltas == 0 and predictor == P_ZERO:
        # bulk LUT path: build an extended lookup for all indices present
        idx = np.clip(indices, 0, palette_size - 1) if nb == 1 else indices
        for c in range(nb):
            out = np.empty((h, w), dtype=np.int32)
            uniq = np.unique(idx)
            lut = {int(u): get_palette_value(palette, int(u), c, palette_size,
                                             bit_depth) for u in uniq}
            flat = np.vectorize(lambda u: lut[int(u)],
                                otypes=[np.int32])(idx)
            out[:, :] = flat
            image.channel[c0 + c].data = out
    else:
        # delta palette: sequential prediction per channel
        for c in range(nb):
            ch = image.channel[c0 + c]
            plane = np.zeros((h, w), dtype=np.int32)
            wp_state = WeightedState(wp_header, w, h) \
                if predictor == P_WEIGHTED else None
            for y in range(h):
                for x in range(w):
                    index = int(indices[y][x])
                    entry = get_palette_value(palette, index, c, palette_size,
                                              bit_depth)
                    if index < nb_deltas:
                        left, top, topleft, topright, leftleft, toptop, trr = \
                            neighbors(plane, x, y, w)
                        if predictor == P_WEIGHTED:
                            wp_pred, _ = wp_state.predict(
                                x, y, w, top, left, topright, topleft, toptop)
                        else:
                            wp_pred = 0
                        val = predict_one(predictor, left, top, toptop,
                                          topleft, topright, leftleft, trr,
                                          wp_pred) + entry
                    else:
                        val = entry
                    plane[y][x] = val
                    if wp_state is not None:
                        wp_state.update_errors(val, x, y, w)
            image.channel[c0 + c].data = plane
    if c0 >= image.nb_meta_channels:
        image.nb_meta_channels -= 1
    else:
        image.nb_meta_channels -= 2 - nb
    del image.channel[0]


def fwd_delta_palette(image: ModularImage, begin_c: int, num_c: int,
                      max_colors: int = 256,
                      predictor: int = 5) -> "Transform | None":
    """Lossy delta palette (FwdPalette lossy path, enc_palette.cc:212-380,
    simplified): each pixel is either a palette color or one of the 143
    implicit delta entries applied to the predictor's estimate. Sequential
    per-pixel scan (prediction feedback), intended for small images /
    graphics content.

    predictor: any non-Zero predictor id (5 = Gradient). Returns the
    Transform or None when the content has too many distinct colors for
    the budget to help."""
    from .predict import neighbors, predict_one

    end_c = begin_c + num_c - 1
    if end_c >= len(image.channel) or num_c > 3:
        return None
    chans = [image.channel[begin_c + i].data.astype(np.int64)
             for i in range(num_c)]
    h, w = chans[0].shape
    stacked = np.stack([c.reshape(-1) for c in chans], axis=1)
    colors, counts = np.unique(stacked, axis=0, return_counts=True)
    # palette = most frequent colors within budget
    top = np.argsort(-counts)[:max_colors]
    palette_colors = colors[top]
    bit_depth = min(image.bitdepth, 24)
    shift = (1 << (bit_depth - 8)) if bit_depth > 8 else 1
    # implicit delta vectors as the decoder reconstructs them
    n_imp = 1 + 2 * (len(_DELTA_PALETTE) - 1)
    deltas = np.zeros((n_imp, 3), dtype=np.int64)
    for k in range(n_imp):
        sign = -1 if (k & 1) == 0 else 1
        deltas[k] = _DELTA_PALETTE[(k + 1) >> 1] * sign * shift
    planes = [np.zeros((h, w), dtype=np.int64) for _ in range(num_c)]
    indices = np.zeros((h, w), dtype=np.int32)
    pal = palette_colors  # (P, num_c)
    dl = deltas[:, :num_c]
    for y in range(h):
        for x in range(w):
            target = stacked[y * w + x]
            # candidate 1: nearest palette color
            derr = np.abs(pal - target[None]).sum(axis=1)
            pi = int(np.argmin(derr))
            pal_err = int(derr[pi])
            # candidate 2: implicit delta from prediction
            pred = np.empty(num_c, dtype=np.int64)
            for c in range(num_c):
                left, top_, topleft, topright, leftleft, toptop, trr = \
                    neighbors(planes[c], x, y, w)
                pred[c] = predict_one(predictor, left, top_, toptop,
                                      topleft, topright, leftleft, trr, 0)
            want = target - pred
            derr2 = np.abs(dl - want[None]).sum(axis=1)
            di = int(np.argmin(derr2))
            del_err = int(derr2[di])
            if del_err < pal_err:
                indices[y, x] = -(di + 1)
                vals = pred + dl[di]
            else:
                indices[y, x] = pi
                vals = pal[pi]
            for c in range(num_c):
                planes[c][y, x] = vals[c]
    # build the transformed image: palette meta channel + index channel
    pch = Channel(len(pal), num_c, -1, -1,
                  pal.T.astype(np.int32).copy())
    idx_ch = Channel(w, h, image.channel[begin_c].hshift,
                     image.channel[begin_c].vshift, indices)
    del image.channel[begin_c + 1:end_c + 1]
    image.channel[begin_c] = idx_ch
    image.channel.insert(0, pch)
    if begin_c >= image.nb_meta_channels:
        image.nb_meta_channels += 1
    else:
        image.nb_meta_channels += 2 - num_c
    t = Transform()
    t.id = T_PALETTE
    t.begin_c = begin_c
    t.num_c = num_c
    t.nb_colors = len(pal)
    t.nb_deltas = 0
    t.predictor = predictor
    return t


def fwd_palette(image: ModularImage, begin_c: int, num_c: int,
                max_colors: int = 256) -> "Transform | None":
    """Forward palette (simplified FwdPalette, enc_palette.cc:164-520):
    exact (non-lossy, non-delta) palettization when the channel tuple count
    fits. Returns the Transform to signal, or None if not applicable.

    Channels are replaced by one index channel; a meta palette channel of
    shape (num_c, nb_colors) is prepended and nb_meta_channels bumped
    (mirror of meta_palette)."""
    end_c = begin_c + num_c - 1
    if end_c >= len(image.channel):
        return None
    chans = [image.channel[begin_c + i].data for i in range(num_c)]
    h, w = chans[0].shape
    stacked = np.stack([c.reshape(-1) for c in chans], axis=1)
    # cheap early bail (photos): if a small sample already exceeds the
    # color budget, skip the O(n log n) full unique
    n = len(stacked)
    if n > 1 << 16:
        step = n // (1 << 14)
        sample = np.unique(stacked[::step], axis=0)
        if len(sample) > max_colors:
            return None
    colors, inverse = np.unique(stacked, axis=0, return_inverse=True)
    if len(colors) > max_colors:
        return None
    # sort palette on luma-ish sum for better index locality (the
    # reference sorts on luma, enc_palette.cc:409-420)
    order = np.argsort(colors.sum(axis=1), kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    colors = colors[order]
    indices = rank[inverse].reshape(h, w).astype(np.int32)
    # build transformed image: palette meta channel + index channel
    pch = Channel(len(colors), num_c, -1, -1,
                  colors.T.astype(np.int32).copy())
    idx_ch = Channel(w, h, image.channel[begin_c].hshift,
                     image.channel[begin_c].vshift, indices)
    del image.channel[begin_c + 1:end_c + 1]
    image.channel[begin_c] = idx_ch
    image.channel.insert(0, pch)
    if begin_c >= image.nb_meta_channels:
        image.nb_meta_channels += 1
    else:
        image.nb_meta_channels += 2 - num_c
    t = Transform()
    t.id = T_PALETTE
    t.begin_c = begin_c
    t.num_c = num_c
    t.nb_colors = len(colors)
    t.nb_deltas = 0
    t.predictor = P_ZERO
    return t
