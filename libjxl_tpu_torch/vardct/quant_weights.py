"""Dequantization matrices: 17 table kinds, library defaults + computation.

Mirrors lib/jxl/quant_weights.cc: GetQuantWeights radial interpolation
(:123-155), ComputeQuantTable per-mode assembly (:157-355), DecodeDC
(:507-522). Table parameters come from quant_weights_defaults.py
(extracted library constants).
"""

from __future__ import annotations

import functools

import numpy as np

from ..base.status import JXLError
from .ac_strategy import (
    NUM_QUANT_TABLES,
    QUANT_REQUIRED_X,
    QUANT_REQUIRED_Y,
    QUANT_TABLE,
    coefficient_layout,
)
from .quant_weights_defaults import LIBRARY_DEFAULTS

ALMOST_ZERO = 1e-8
# kInvDCQuant (quant_weights.h:295-299)
INV_DC_QUANT = np.array([4096.0, 512.0, 256.0], dtype=np.float32)
DC_QUANT = 1.0 / INV_DC_QUANT

AFV_FREQS = [0.0, 0.0, 0.8517778890324296, 5.37778436506804,
             0.0, 0.0, 4.734747904497923, 5.449245381693219,
             1.6598270267479331, 4.0, 7.275749096817861, 10.423227632456525,
             2.662932286148962, 7.630657783650829, 8.962388608184032,
             12.97166202570235]


def _mult(v: float) -> float:
    return 1.0 + v if v > 0 else 1.0 / (1.0 - v)


def _interpolate(pos, maxv, array):
    """Log-linear interpolation (quant_weights.cc:86-94), vectorized."""
    pos = np.asarray(pos, dtype=np.float64)
    scaled = pos * (len(array) - 1) / maxv
    idx = np.minimum(scaled.astype(np.int64), len(array) - 2)
    frac = scaled - idx
    arr = np.asarray(array, dtype=np.float64)
    a = arr[idx]
    b = arr[np.minimum(idx + 1, len(array) - 1)]
    return a * np.power(b / a, frac)


def get_quant_weights(rows: int, cols: int, distance_bands) -> np.ndarray:
    """GetQuantWeights (quant_weights.cc:123-155): (3, rows, cols) weights."""
    out = np.zeros((3, rows, cols))
    for c in range(3):
        db = distance_bands[c]
        bands = [db[0]]
        if bands[0] < ALMOST_ZERO:
            raise JXLError("invalid distance bands")
        for i in range(1, len(db)):
            bands.append(bands[-1] * _mult(db[i]))
            if bands[-1] < ALMOST_ZERO:
                raise JXLError("invalid distance bands")
        num_bands = len(db)
        scale = (num_bands - 1) / (np.sqrt(2.0) + 1e-6)
        rcpcol = scale / (cols - 1) if cols > 1 else 0.0
        rcprow = scale / (rows - 1) if rows > 1 else 0.0
        dy = np.arange(rows)[:, None] * rcprow
        dx = np.arange(cols)[None, :] * rcpcol
        dist = np.sqrt(dx * dx + dy * dy)
        if num_bands == 1:
            out[c] = bands[0]
        else:
            out[c] = _interpolate_banded(dist, bands)
    return out


def _interpolate_banded(scaled_distance, bands):
    """InterpolateVec semantics: scaled_distance is already in band units
    (quant_weights.cc:103-121)."""
    arr = np.asarray(bands, dtype=np.float64)
    idx = scaled_distance.astype(np.int64)
    idx = np.minimum(idx, len(bands) - 2)
    frac = scaled_distance - idx
    a = arr[idx]
    b = arr[idx + 1]
    return a * np.power(b / a, frac)


def compute_quant_table(entry, kind: int) -> np.ndarray:
    """ComputeQuantTable (quant_weights.cc:157-355): (3, rows*8, cols*8)
    weights (NOT inverted; dequant matrix = 1/weights)."""
    wrows = 8 * QUANT_REQUIRED_X[kind]
    wcols = 8 * QUANT_REQUIRED_Y[kind]
    mode = entry[0]
    if mode == "dct":
        weights = get_quant_weights(wrows, wcols, entry[1])
    elif mode == "id":
        weights = np.zeros((3, 8, 8))
        for c in range(3):
            weights[c, :, :] = entry[1][c][0]
            weights[c, 0, 1] = entry[1][c][1]
            weights[c, 1, 0] = entry[1][c][1]
            weights[c, 1, 1] = entry[1][c][2]
    elif mode == "dct2":
        weights = np.zeros((3, 8, 8))
        for c in range(3):
            w = entry[1][c]
            ww = weights[c]
            ww[0, 0] = 0xBAD  # sentinel as in the reference; LLF, unused
            ww[0, 1] = ww[1, 0] = w[0]
            ww[1, 1] = w[1]
            ww[0:2, 2:4] = w[2]
            ww[2:4, 0:2] = w[2]
            ww[2:4, 2:4] = w[3]
            ww[0:4, 4:8] = w[4]
            ww[4:8, 0:4] = w[4]
            ww[4:8, 4:8] = w[5]
    elif mode == "dct4":
        w4 = get_quant_weights(4, 4, entry[1])
        weights = np.repeat(np.repeat(w4, 2, axis=1), 2, axis=2)
        for c in range(3):
            weights[c, 0, 1] /= entry[2][c][0]
            weights[c, 1, 0] /= entry[2][c][0]
            weights[c, 1, 1] /= entry[2][c][1]
    elif mode == "dct4x8":
        w48 = get_quant_weights(4, 8, entry[1])
        weights = np.repeat(w48, 2, axis=1)
        for c in range(3):
            weights[c, 1, 0] /= entry[2][c]
    elif mode == "afv":
        w4x8 = get_quant_weights(4, 8, entry[1])
        w4x4 = get_quant_weights(4, 4, entry[2])
        weights = np.zeros((3, 8, 8))
        lo = 0.8517778890324296
        hi = 12.97166202570235 - lo + 1e-6
        for c in range(3):
            aw = entry[3][c]
            bands = [aw[5]]
            for i in range(1, 4):
                bands.append(bands[-1] * _mult(aw[5 + i]))
            ww = weights[c]
            ww[0, 0] = 1.0  # unused (LLF)
            ww[1, 0] = aw[0]
            ww[0, 1] = aw[1]
            ww[2, 0] = aw[2]
            ww[0, 2] = aw[3]
            ww[2, 2] = aw[4]
            for y in range(4):
                for x in range(4):
                    if x < 2 and y < 2:
                        continue
                    val = _interpolate(np.array(AFV_FREQS[y * 4 + x] - lo),
                                       hi, bands)
                    ww[2 * y, 2 * x] = float(val)
            for y in range(4):
                for x in range(8):
                    if x == 0 and y == 0:
                        continue
                    ww[2 * y + 1, x] = w4x8[c, y, x]
            for y in range(4):
                for x in range(4):
                    if x == 0 and y == 0:
                        continue
                    ww[2 * y, 2 * x + 1] = w4x4[c, y, x]
    else:
        raise JXLError(f"unknown quant mode {mode}")
    if np.any(weights < ALMOST_ZERO) or np.any(weights >= 1.0 / ALMOST_ZERO):
        raise JXLError("invalid quantization table")
    return weights


@functools.lru_cache(maxsize=1)
def library_tables():
    """-> list of 17 (dequant, inv_dequant) pairs, each (3, rows*8, cols*8)
    float32; inv_dequant LLF entries zeroed (quant_weights.cc:341-353)."""
    out = []
    for kind in range(NUM_QUANT_TABLES):
        weights = compute_quant_table(LIBRARY_DEFAULTS[kind], kind)
        dequant = (1.0 / weights).astype(np.float32)
        inv = weights.astype(np.float32).copy()
        xs, ys = QUANT_REQUIRED_X[kind], QUANT_REQUIRED_Y[kind]
        ys2, xs2 = coefficient_layout(ys, xs)
        inv[:, :ys2, :xs2] = 0  # LLF region in wide layout
        out.append((dequant, inv))
    return out


# QuantEncoding::Mode (quant_weights.h:59-67)
MODE_LIBRARY = 0
MODE_ID = 1
MODE_DCT2 = 2
MODE_DCT4 = 3
MODE_DCT4X8 = 4
MODE_AFV = 5
MODE_DCT = 6
MODE_RAW = 7

LOG2_NUM_QUANT_MODES = 3
LOG2_MAX_DISTANCE_BANDS = 4


def _f16(v):
    """Round through binary16 like F16Coder so encoder matrices match the
    decoder's bit-for-bit."""
    return float(np.float16(v))


def _decode_dct_params(r):
    """DecodeDctParams (quant_weights.cc:367-380)."""
    from ..io.fields import f16_read

    n = r.read_bits(LOG2_MAX_DISTANCE_BANDS) + 1
    bands = []
    for _c in range(3):
        row = [f16_read(r) for _ in range(n)]
        if row[0] < ALMOST_ZERO:
            raise JXLError("distance band seed too small")
        row[0] *= 64.0
        bands.append(row)
    return bands


def _encode_dct_params(bands, w):
    """EncodeDctParams (enc_quant_weights.cc:26-37)."""
    from ..io.fields import f16_write

    n = len(bands[0])
    w.write(LOG2_MAX_DISTANCE_BANDS, n - 1)
    for c in range(3):
        for i, v in enumerate(bands[c]):
            f16_write(v / 64.0 if i == 0 else v, w)


def quant_table_stream_id(num_dc_groups: int, idx: int) -> int:
    """ModularStreamId::QuantTable (dec_modular.h:56-60)."""
    return 1 + 3 * num_dc_groups + idx


def compute_custom_table(entry, kind: int):
    """-> (dequant, inv_dequant) like one element of library_tables()."""
    if entry[0] == "raw":
        den, qtable = entry[1], np.asarray(entry[2], dtype=np.float64)
        if np.any(qtable <= 0):
            raise JXLError("invalid raw quantization table")
        dequant = (den * qtable).astype(np.float32)
        inv = (1.0 / (den * qtable)).astype(np.float32).copy()
    else:
        weights = compute_quant_table(entry, kind)
        dequant = (1.0 / weights).astype(np.float32)
        inv = weights.astype(np.float32).copy()
    xs, ys = QUANT_REQUIRED_X[kind], QUANT_REQUIRED_Y[kind]
    ys2, xs2 = coefficient_layout(ys, xs)
    inv[:, :ys2, :xs2] = 0
    return dequant, inv


class DequantMatrices:
    """Runtime dequant matrix set: library defaults or signaled custom
    encodings per table kind (quant_weights.cc:382-505)."""

    def __init__(self):
        self.tables = list(library_tables())
        self.dc_quant = DC_QUANT.copy()
        self.inv_dc_quant = INV_DC_QUANT.copy()
        self.encodings = [None] * NUM_QUANT_TABLES  # None = library

    def dequant_matrix(self, kind: int, c: int) -> np.ndarray:
        return self.tables[kind][0][c]

    def inv_matrix(self, kind: int, c: int) -> np.ndarray:
        return self.tables[kind][1][c]

    def table_for_strategy(self, strategy: int) -> int:
        return QUANT_TABLE[strategy]

    def set_custom(self, kind: int, entry) -> None:
        """Install a custom encoding for one table kind. entry formats:
        library-defaults style ("dct"/"id"/"dct2"/"dct4"/"dct4x8"/"afv",
        params...) or ("raw", den, qtable (3, rows, cols) ints).
        Float params are rounded through f16 exactly as the decoder will
        reconstruct them, so encoder and decoder matrices match."""

        def bands64(bands):
            # stored band0 must equal f16(b0/64)*64 (the decoder's value)
            return [[_f16(row[0] / 64.0) * 64.0] + [_f16(v)
                                                    for v in row[1:]]
                    for row in bands]

        def w64(rows):
            return [[_f16(v / 64.0) * 64.0 for v in row] for row in rows]

        mode = entry[0]
        if mode == "raw":
            entry = ("raw", _f16(entry[1]),
                     np.asarray(entry[2], dtype=np.int32))
        elif mode == "dct":
            entry = ("dct", bands64(entry[1]))
        elif mode in ("id", "dct2"):
            entry = (mode, w64(entry[1]))
        elif mode == "dct4":
            entry = ("dct4", bands64(entry[1]),
                     [[_f16(v) for v in row] for row in entry[2]])
        elif mode == "dct4x8":
            entry = ("dct4x8", bands64(entry[1]),
                     [_f16(v) for v in entry[2]])
        elif mode == "afv":
            ws = [[_f16(v / 64.0) * 64.0 if i < 6 else _f16(v)
                   for i, v in enumerate(row)] for row in entry[3]]
            entry = ("afv", bands64(entry[1]), bands64(entry[2]), ws)
        else:
            raise JXLError(f"unknown quant mode {mode}")
        self.encodings[kind] = entry
        self.tables[kind] = compute_custom_table(entry, kind)

    def decode_dc(self, r) -> None:
        """quant_weights.cc:507-522."""
        from ..io.fields import f16_read

        if not r.read_bits(1):
            for c in range(3):
                v = f16_read(r) / 128.0
                if v < ALMOST_ZERO:
                    raise JXLError("invalid dc_quant")
                self.dc_quant[c] = v
                self.inv_dc_quant[c] = 1.0 / v

    def set_custom_dc(self, values) -> None:
        """Custom DC dequant steps (DequantMatricesSetCustomDC analog);
        values are f16-rounded exactly as the decoder reconstructs."""
        self._custom_dc = True
        for c in range(3):
            v = _f16(values[c] * 128.0) / 128.0
            self.dc_quant[c] = v
            self.inv_dc_quant[c] = 1.0 / v

    def encode_dc(self, w) -> None:
        from ..io.fields import f16_write

        if getattr(self, "_custom_dc", False):
            w.write(1, 0)
            for c in range(3):
                f16_write(self.dc_quant[c] * 128.0, w)
        else:
            w.write(1, 1)  # all_default

    def decode(self, r, num_dc_groups: int = 1, global_tree=None,
               global_code=None, global_ctx_map=None) -> None:
        """DequantMatrices::Decode (quant_weights.cc:382-505)."""
        from ..io.fields import f16_read

        if r.read_bits(1) == 1:
            return  # all default
        for kind in range(NUM_QUANT_TABLES):
            mode = r.read_bits(LOG2_NUM_QUANT_MODES)
            size_ok = QUANT_REQUIRED_X[kind] * QUANT_REQUIRED_Y[kind] == 1
            if mode == MODE_LIBRARY:
                # kCeilLog2NumPredefinedTables == 0: no bits
                self.encodings[kind] = None
                self.tables[kind] = library_tables()[kind]
                continue
            if mode == MODE_ID:
                if not size_ok:
                    raise JXLError("invalid quant mode for table size")
                ws = [[f16_read(r) * 64.0 for _ in range(3)]
                      for _c in range(3)]
                if any(abs(v) < ALMOST_ZERO for row in ws for v in row):
                    raise JXLError("ID quantizer too small")
                entry = ("id", ws)
            elif mode == MODE_DCT2:
                if not size_ok:
                    raise JXLError("invalid quant mode for table size")
                ws = [[f16_read(r) * 64.0 for _ in range(6)]
                      for _c in range(3)]
                if any(abs(v) < ALMOST_ZERO for row in ws for v in row):
                    raise JXLError("DCT2 quantizer too small")
                entry = ("dct2", ws)
            elif mode == MODE_DCT4:
                if not size_ok:
                    raise JXLError("invalid quant mode for table size")
                muls = [[f16_read(r) for _ in range(2)] for _c in range(3)]
                if any(abs(v) < ALMOST_ZERO for row in muls for v in row):
                    raise JXLError("DCT4 multiplier too small")
                entry = ("dct4", _decode_dct_params(r), muls)
            elif mode == MODE_DCT4X8:
                if not size_ok:
                    raise JXLError("invalid quant mode for table size")
                muls = [f16_read(r) for _c in range(3)]
                if any(abs(v) < ALMOST_ZERO for v in muls):
                    raise JXLError("DCT4X8 multiplier too small")
                entry = ("dct4x8", _decode_dct_params(r), muls)
            elif mode == MODE_AFV:
                if not size_ok:
                    raise JXLError("invalid quant mode for table size")
                ws = []
                for _c in range(3):
                    row = [f16_read(r) for _ in range(9)]
                    for i in range(6):
                        row[i] *= 64.0
                    ws.append(row)
                entry = ("afv", _decode_dct_params(r),
                         _decode_dct_params(r), ws)
            elif mode == MODE_DCT:
                entry = ("dct", _decode_dct_params(r))
            elif mode == MODE_RAW:
                den = f16_read(r)
                if den < ALMOST_ZERO:
                    raise JXLError("invalid qtable_den")
                from ..modular.codec import ModularOptions, modular_decode
                from ..modular.image import Channel, ModularImage

                rows = 8 * QUANT_REQUIRED_X[kind]
                cols = 8 * QUANT_REQUIRED_Y[kind]
                img = ModularImage(cols, rows, 8, 0)
                img.channel = [Channel(cols, rows, 0, 0) for _ in range(3)]
                modular_decode(
                    r, img, quant_table_stream_id(num_dc_groups, kind),
                    ModularOptions(), global_tree=global_tree,
                    global_code=global_code, global_ctx_map=global_ctx_map,
                    undo_transforms=True)
                qtable = np.stack([ch.data for ch in img.channel])
                entry = ("raw", den, qtable)
            else:
                raise JXLError("invalid quantization table encoding")
            self.encodings[kind] = entry
            self.tables[kind] = compute_custom_table(entry, kind)

    def encode(self, w, num_dc_groups: int = 1) -> None:
        """DequantMatricesEncode (enc_quant_weights.cc:39-135)."""
        from ..io.fields import f16_write

        if all(e is None for e in self.encodings):
            w.write(1, 1)  # all_default
            return
        w.write(1, 0)
        for kind in range(NUM_QUANT_TABLES):
            entry = self.encodings[kind]
            if entry is None:
                w.write(LOG2_NUM_QUANT_MODES, MODE_LIBRARY)
                continue
            mode = {"id": MODE_ID, "dct2": MODE_DCT2, "dct4": MODE_DCT4,
                    "dct4x8": MODE_DCT4X8, "afv": MODE_AFV,
                    "dct": MODE_DCT, "raw": MODE_RAW}[entry[0]]
            w.write(LOG2_NUM_QUANT_MODES, mode)
            if mode == MODE_ID:
                for c in range(3):
                    for i in range(3):
                        f16_write(entry[1][c][i] / 64.0, w)
            elif mode == MODE_DCT2:
                for c in range(3):
                    for i in range(6):
                        f16_write(entry[1][c][i] / 64.0, w)
            elif mode == MODE_DCT4:
                for c in range(3):
                    for i in range(2):
                        f16_write(entry[2][c][i], w)
                _encode_dct_params(entry[1], w)
            elif mode == MODE_DCT4X8:
                for c in range(3):
                    f16_write(entry[2][c], w)
                _encode_dct_params(entry[1], w)
            elif mode == MODE_AFV:
                for c in range(3):
                    for i in range(9):
                        v = entry[3][c][i]
                        f16_write(v / 64.0 if i < 6 else v, w)
                _encode_dct_params(entry[1], w)
                _encode_dct_params(entry[2], w)
            elif mode == MODE_DCT:
                _encode_dct_params(entry[1], w)
            else:  # RAW
                den, qtable = entry[1], entry[2]
                f16_write(den, w)
                from ..io.bits import BitWriter
                from ..modular.codec import GroupHeader, _tokenize_channel
                from ..modular.image import Channel, ModularImage
                from ..modular.predict import P_GRADIENT
                from ..modular.tree import (
                    encode_tree,
                    make_fixed_tree,
                    num_tree_contexts,
                )
                from ..entropy.encode import (
                    build_and_encode_histograms,
                    write_tokens,
                )

                rows, cols = qtable.shape[1], qtable.shape[2]
                img = ModularImage(cols, rows, 8, 0)
                img.channel = [
                    Channel(cols, rows, 0, 0,
                            np.asarray(qtable[c], dtype=np.int32))
                    for c in range(3)]
                gh = GroupHeader()  # local tree
                gh.write(w)
                tree = make_fixed_tree(P_GRADIENT)
                dec_tree = encode_tree(tree, w)
                tokens = []
                sid = quant_table_stream_id(num_dc_groups, kind)
                for i in range(3):
                    _tokenize_channel(img, i, sid, dec_tree, gh.wp_header,
                                      tokens)
                codes, cmap = build_and_encode_histograms(
                    [tokens], num_tree_contexts(dec_tree), w)
                write_tokens(tokens, codes, cmap, w)
