"""The AC-global section in native C (native/vardct_decode.c): adaptive DC
smoothing, the ANS histogram set (its histograms read and made alias
tables) and the context map's checks, each against the port's Python
body, which runs where the library is not there; and the
launch_counter("ac_global_native") count, once a frame whose AC histogram
sets were made in C."""

import pathlib

import numpy as np
import pytest

from libjxl_tpu_torch import native_ext
from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.api import tpu_codec
from libjxl_tpu_torch.base.device import launch_counts
from libjxl_tpu_torch.base.status import JXLError
from libjxl_tpu_torch.entropy import decode as edec
from libjxl_tpu_torch.entropy.alias import (ALIAS_FIELDS, alias_table_views,
                                            init_alias_table,
                                            stacked_alias_fields)
from libjxl_tpu_torch.entropy.encode import (Token, _MtfEncoder,
                                             build_and_encode_histograms,
                                             write_tokens)
from libjxl_tpu_torch.entropy.hybrid_uint import HybridUintConfig
from libjxl_tpu_torch.io.bits import BitReader, BitWriter
from libjxl_tpu_torch.io.container import extract_codestream
from libjxl_tpu_torch.vardct import frame as vf
from test_torch_host import _assert_same

TRANSCODE = pathlib.Path(__file__).resolve().parent / "data" / \
    "transcode" / "dc_contexts_420.jxl"
# Quantizer.mul_dc of a d1 frame, as it gives them (float32)
FAC = tuple(np.float32(f) for f in (0.00018259838, 0.001460787,
                                     0.002921574))
KINDS = ("normal", "steps", "extreme", "nonfinite")


def _lib():
    lib = native_ext.get_lib()
    assert lib is not None, "the native library did not build"
    return lib


def _image(h, w, seed):
    """vardct_photo's generator: smooth photo-like content, mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (120 + 60 * np.sin(xx * 0.003) + 50 * np.cos(yy * 0.002 + 1)
           + 20 * np.sin((xx + yy) * 0.01) + rng.normal(0, 5, (h, w)))
    rgb = np.stack([img, img * 0.9 + 10, img * 1.1 - 12], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def e3_2048():
    """A 2048^2 d1/e3 stream, the batch cell's frame."""
    return tcs.encode_lossy(_image(2048, 2048, 1), distance=1.0, effort=3,
                            device=None)


def _dc(shape, kind):
    rng = np.random.default_rng([*shape, KINDS.index(kind)])
    dc = rng.normal(0, 0.05, shape)
    if kind == "steps":           # a smooth DC on each channel's step grid
        yy, xx = np.mgrid[0:shape[1], 0:shape[2]]
        smooth = 0.02 * np.sin(xx * 0.05) + 0.01 * np.cos(yy * 0.07)
        dc = np.stack([np.round((smooth + rng.normal(0, f, shape[1:])) / f)
                       * f for f in map(float, FAC)])
    elif kind == "extreme":       # overflowing sums, subnormals, zeros
        dc = dc * rng.choice([1e308, -1e308, 1e300, 5e-324, 1e-310, 0.0,
                              -0.0, 1.0], size=shape)
    elif kind == "nonfinite":
        dc = rng.choice([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e308, 1.0],
                        size=shape)
    return dc


def _same_bits(a, b):
    """Equal as assert_array_equal has it (NaN equals NaN), and bit for
    bit wherever the value is a number (the sign of a NaN made from two
    NaNs is the compiler's operand order, unspecified by IEEE 754)."""
    assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    num = ~np.isnan(a)
    np.testing.assert_array_equal(a[num].view(np.uint64),
                                  b[num].view(np.uint64))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(3, 3, 3), (3, 2, 9), (3, 256, 256),
                                   (3, 37, 300)],
                         ids=["3x3", "2x9", "256x256", "37x300"])
def test_native_dc_smoothing_equals_the_numpy_body(shape, kind, monkeypatch):
    dc = _dc(shape, kind)
    with np.errstate(all="ignore"):
        got = vf.adaptive_dc_smoothing(dc, FAC)
        monkeypatch.setattr(native_ext, "get_lib", lambda: None)
        want = vf.adaptive_dc_smoothing(dc, FAC)
    if min(shape[1:]) <= 2:
        assert got is dc and want is dc      # nothing to smooth
    _same_bits(got, want)


def test_native_dc_smoothing_of_a_decoded_frame(e3_2048, monkeypatch):
    """The DC of a 2048^2 e3 frame as the AC-global section smooths it."""
    seen = []
    smooth = vf.adaptive_dc_smoothing

    def spy(dc, fac):
        seen.append((dc.copy(), list(fac)))
        return smooth(dc, fac)

    monkeypatch.setattr(vf, "adaptive_dc_smoothing", spy)
    (state,), _ = tpu_codec._parse([e3_2048], ac_raw=True)
    ((dc, fac),) = seen
    assert dc.shape == (3, 256, 256)
    _same_bits(state.dc, vf.adaptive_dc_smoothing_numpy(dc, fac))
    _same_bits(native_ext.adaptive_dc_smoothing_native(_lib(), dc, fac),
               vf.adaptive_dc_smoothing_numpy(dc, fac))


def _alias_cases():
    rng = np.random.default_rng(7)
    cases = []
    for las in (5, 6, 7, 8):
        for n in (2, 5, 1 << las):      # the last: an alphabet at table size
            w = rng.random(n) ** 3
            d = np.floor(w / w.sum() * 4096).astype(int)
            d[int(np.argmax(d))] += 4096 - d.sum()
            cases.append((f"random-{las}-{n}", list(d), las))
    cases += [("single", [0, 0, 4096], 5), ("single-first", [4096], 8),
              ("trailing-zeros", [1000, 0, 3096, 0, 0, 0], 6),
              ("all-zero", [0, 0, 0], 5), ("empty", [], 7),
              ("ones", [1] * 31 + [4065], 5)]
    return cases


@pytest.mark.parametrize("name,dist,las", _alias_cases(),
                         ids=[c[0] for c in _alias_cases()])
def test_native_alias_tables_equal_init_alias_table(name, dist, las):
    tables = native_ext.init_alias_tables_native(_lib(), [dist, dist], las)
    assert tables.shape == (5, 2, 1 << las) and tables.dtype == np.uint16
    want = init_alias_table(dist, las)
    for got in alias_table_views(tables, las):
        for f in ALIAS_FIELDS:
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(want, f), err_msg=f)
    views = alias_table_views(tables, las)
    assert stacked_alias_fields(views, las) is tables
    np.testing.assert_array_equal(stacked_alias_fields([want, want], las),
                                  tables)


@pytest.mark.parametrize("dist,las", [([1000, 1000], 5), ([4097], 5),
                                      ([4095, 0, 0, 0], 8),
                                      ([128] * 33, 5)],
                         ids=["sum-low", "sum-high", "sum-trailing",
                              "too-long"])
def test_native_alias_tables_raise_where_init_alias_table_does(dist, las):
    with pytest.raises(JXLError) as want:
        init_alias_table(dist, las)
    with pytest.raises(JXLError) as got:
        native_ext.init_alias_tables_native(_lib(), [[4096], dist], las)
    assert str(got.value) == str(want.value)


def _set_stream(seed):
    """A histogram set the port's encoder writes: random tokens in 40
    contexts, clustered, at a seeded log alphabet size, then one bit."""
    rng = np.random.default_rng(seed)
    tokens = [Token(int(c), int(v)) for c, v in zip(
        rng.integers(0, 40, 3000),
        rng.geometric(rng.uniform(0.05, 0.6), 3000) - 1)]
    w = BitWriter()
    build_and_encode_histograms([tokens], 40, w,
                                force_log_alpha=int(5 + seed % 4))
    w.write(1, 1)
    return w.get_bytes()


def _decode_set(data, num_contexts):
    r = BitReader(data)
    code, cmap, native = edec.decode_histogram_set(r, num_contexts)
    return code, cmap, native, r.total_bits_consumed()


@pytest.mark.parametrize("seed", range(8))
def test_native_histogram_set_equals_the_python_reads(seed, monkeypatch):
    """decode_histograms of an encoder's set: the same code, context map
    and bit position in C as in Python."""
    data = _set_stream(seed)
    code, cmap, native, pos = _decode_set(data, 40)
    assert native and not code.use_prefix_code
    monkeypatch.setattr(native_ext, "get_lib", lambda: None)
    pcode, pcmap, pnative, ppos = _decode_set(data, 40)
    assert not pnative and pos == ppos
    _assert_same(pcode, code, "code")
    _assert_same(pcmap, cmap, "context map")


def _outcome(data, num_contexts):
    try:
        code, cmap, _, pos = _decode_set(data, num_contexts)
    except JXLError as e:
        return "JXLError", str(e)
    return code, cmap, pos


@pytest.mark.parametrize("block", range(4))
def test_corrupt_histogram_sets_fail_as_in_python(block, monkeypatch):
    """Seeded random bytes and bit-flipped encoder sets, 64 a block: the
    C path raises the JXLError Python raises, or reads what it reads."""
    rng = np.random.default_rng(100 + block)
    inputs = []
    for i in range(64):
        if i % 2:
            data = bytearray(_set_stream(1000 + 64 * block + i))
            for _ in range(3):
                k = int(rng.integers(0, 8 * len(data)))
                data[k // 8] ^= 1 << (k % 8)
            inputs.append(bytes(data))
        else:
            inputs.append(rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
    with np.errstate(all="ignore"):
        got = [_outcome(d, 40) for d in inputs]
        monkeypatch.setattr(native_ext, "get_lib", lambda: None)
        want = [_outcome(d, 40) for d in inputs]
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(w, g, f"input {i}")


def _context_map_stream(cmap, mtf):
    """decode_context_map's ANS form (encode_context_map's, with the MTF
    flag chosen), any values, then one bit."""
    if mtf:
        enc = _MtfEncoder()
        cmap = [enc.encode(v) for v in cmap]
    tokens = [Token(0, v) for v in cmap]
    w = BitWriter()
    w.write(1, 0)
    w.write(1, int(mtf))
    codes, _ = build_and_encode_histograms(
        [tokens], 1, w, uint_config=HybridUintConfig(2, 0, 1),
        allow_clustering=False)
    write_tokens(tokens, codes, [0], w)
    w.write(1, 1)
    return w.get_bytes()


def _read_map(data, n):
    r = BitReader(data)
    try:
        cmap, num = edec.decode_context_map(n, r)
    except JXLError as e:
        return "JXLError", str(e)
    return cmap, num, r.total_bits_consumed()


def _maps():
    rng = np.random.default_rng(11)
    full = rng.integers(0, 30, 1485)
    full[:30] = np.arange(30)
    holed = full.copy()
    holed[holed == 7] = 8
    return {"complete": list(full), "incomplete": list(holed),
            "one": [0] * 200, "wide": list(rng.permutation(250).tolist() * 2)}


@pytest.mark.parametrize("mtf", [False, True], ids=["plain", "mtf"])
@pytest.mark.parametrize("name", sorted(_maps()))
def test_native_context_map_equals_the_python_path(name, mtf, monkeypatch):
    cmap = _maps()[name]
    data = _context_map_stream(cmap, mtf)
    got = _read_map(data, len(cmap))
    monkeypatch.setattr(native_ext, "get_lib", lambda: None)
    want = _read_map(data, len(cmap))
    _assert_same(want, got, "context map")
    if name == "incomplete":
        assert got == ("JXLError", "incomplete context map")
    else:
        assert got[0] == [int(v) for v in cmap]


def test_invalid_mtf_index_raises():
    values = np.array([3] * 70 + [256], dtype=np.uint32)
    with pytest.raises(JXLError, match="invalid MTF index"):
        native_ext.inverse_mtf_native(_lib(), values)
    with pytest.raises(JXLError, match="invalid MTF index"):
        edec.inverse_move_to_front(values.tolist())


def _counted(fn, *args, **kw):
    before = launch_counts().get("ac_global_native", 0)
    out = fn(*args, **kw)
    return out, launch_counts().get("ac_global_native", 0) - before


@pytest.fixture(scope="module")
def e3_512():
    return tcs.encode_lossy(_image(512, 512, 2), distance=1.0, effort=3,
                            device=None)


def test_ac_global_native_counts_a_batch_of_16(e3_512):
    _, n = _counted(tpu_codec.prepare_batch_entropy, [e3_512] * 16)
    assert n == 16


def test_ac_global_native_counts_an_e5_decode():
    data = tcs.encode_lossy(_image(320, 288, 3), distance=1.0, effort=5,
                            device=None)
    _, n = _counted(tcs.decode, data, device=None)
    assert n == 1


def test_ac_global_native_counts_a_recompressed_jpeg_frame():
    """An ANS set of 30 histograms over 1485 contexts, no LZ77."""
    data = extract_codestream(TRANSCODE.read_bytes())
    _, n = _counted(tcs.decode, data, device=None)
    assert n == 1


def _state(data):
    """The frame's state up to its AC groups, which stay raw (the
    device-entropy batch's parse)."""
    (state,), _ = tpu_codec._parse([data], ac_raw=True)
    return state


def test_without_the_library_nothing_counts_and_the_state_is_the_same(
        monkeypatch):
    data = tcs.encode_lossy(_image(320, 288, 4), distance=1.0, effort=3,
                            device=None)        # four AC groups
    native, n = _counted(_state, data)
    assert n == 1
    monkeypatch.setattr(native_ext, "get_lib", lambda: None)
    plain, n = _counted(_state, data)
    assert n == 0
    _assert_same(plain, native, "state")
