"""The port's encoder heuristics on a device (vardct/frame.py
_tile_cost_device, vardct/heuristics.py _refine_device) and the encode
entries that run them, on the CPU, against the JAX package's device forms.

The JAX package runs those forms when its accelerator probe reads True;
the `jax_device` fixture patches the probe (libjxl_tpu.api.tpu_codec.
accelerator_available) to say so, and XLA then runs them on the CPU. No
file of the JAX package changes.

Tolerances: tile costs within rtol 1e-5 of the JAX costs (f32 sums in
another order) and 1e-4 of the host numpy costs (f32 and f64 mixed); the
trial image within atol 1e-5 of the JAX trial; the refined field equal,
except blocks whose JAX field lies within 1e-4 of a rounding boundary in
some round; encoded bytes equal.
"""

import copy

import numpy as np
import pytest
import torch

from libjxl_tpu.api import codestream as jcs
from libjxl_tpu.api import tpu_codec as jtc
from libjxl_tpu.metrics import butteraugli_jax as jba
from libjxl_tpu.vardct import frame as jframe
from libjxl_tpu.vardct import heuristics as jheur
from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.base.device import launch_counts
from libjxl_tpu_torch.metrics import butteraugli_torch as tba
from libjxl_tpu_torch.vardct import ac_strategy as acs
from libjxl_tpu_torch.vardct import frame as tframe
from libjxl_tpu_torch.vardct import heuristics as theur
from libjxl_tpu_torch.vardct.ctx import QUANT_MAX
from test_torch_encode import photo

CPU = torch.device("cpu")
BOUNDARY = 1e-4  # distance of a JAX field value from its rounding boundary
# every tile size of the effort-7 ladder (_choose_ac_strategies)
LADDER = [(8, 8, acs.DCT), (16, 16, acs.DCT16X16), (16, 8, acs.DCT16X8),
          (8, 16, acs.DCT8X16), (32, 32, acs.DCT32X32),
          (32, 16, acs.DCT32X16), (16, 32, acs.DCT16X32),
          (64, 64, acs.DCT64X64), (64, 32, acs.DCT64X32),
          (32, 64, acs.DCT32X64), (128, 128, acs.DCT128X128),
          (128, 64, acs.DCT128X64), (64, 128, acs.DCT64X128),
          (256, 256, acs.DCT256X256), (256, 128, acs.DCT256X128),
          (128, 256, acs.DCT128X256)]


@pytest.fixture
def jax_device(monkeypatch):
    """The JAX package's device forms: its accelerator probe reads True."""
    monkeypatch.setattr(jtc, "accelerator_available", lambda: True)


@pytest.fixture(scope="module")
def acs_inputs():
    """The state and opsin image each package hands its AC-strategy search
    for a seeded 256x256 photo at e5 (host encodes: every layer before the
    search is host code, equal byte for byte)."""
    img = photo(256, 256, 31)
    got = {}

    def spy(key, module):
        real = module._choose_ac_strategies

        def wrapped(state, xyb, *args, **kw):
            got[key] = (copy.deepcopy(state), xyb.copy())
            return real(state, xyb, *args, **kw)

        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jframe, "_choose_ac_strategies", spy("jax", jframe))
        mp.setattr(tframe, "_choose_ac_strategies", spy("port", tframe))
        jcs.encode_lossy(img, distance=1.0, effort=5, device=False)
        tcs.encode_lossy(img, distance=1.0, effort=5, device=None)
    return got


@pytest.mark.parametrize("rows,cols,strategy", LADDER,
                         ids=[f"{r}x{c}" for r, c, _ in LADDER])
def test_tile_cost_matches_the_jax_package(acs_inputs, jax_device, rows,
                                          cols, strategy):
    jstate, jxyb = acs_inputs["jax"]
    tstate, txyb = acs_inputs["port"]
    np.testing.assert_array_equal(txyb, jxyb)
    np.testing.assert_array_equal(tstate.raw_quant_field,
                                  jstate.raw_quant_field)
    kind = acs.QUANT_TABLE[strategy]
    ref = jframe._batched_tile_cost(jstate, jxyb, rows, cols, kind)
    got = tframe._batched_tile_cost(tstate, txyb, rows, cols, kind, CPU)
    host = tframe._batched_tile_cost(tstate, txyb, rows, cols, kind)
    assert got.dtype == np.float64 and got.shape == ref.shape == host.shape
    assert got.size > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got, host, rtol=1e-4)


def test_tile_cost_uploads_the_image_once_a_search(acs_inputs):
    """The opsin image goes to the device once per search: the cached
    tensor is reused for every tile size, and a new image replaces it."""
    tstate, txyb = copy.deepcopy(acs_inputs["port"])
    kind = acs.QUANT_TABLE[acs.DCT]
    tframe._batched_tile_cost(tstate, txyb, 8, 8, kind, CPU)
    cached = tstate._xyb_dev
    tframe._batched_tile_cost(tstate, txyb, 16, 16,
                              acs.QUANT_TABLE[acs.DCT16X16], CPU)
    assert tstate._xyb_dev is cached and cached[0] is txyb
    other = txyb.copy()
    tframe._batched_tile_cost(tstate, other, 8, 8, kind, CPU)
    assert tstate._xyb_dev[0] is other


@pytest.fixture(scope="module")
def refine_case():
    """The JAX package's device refinement in an e7 encode of a seeded
    96x112 photo (XLA on the CPU): its arguments, the trial image of each
    round, the field ratio of each round and the field it leaves."""
    img = photo(96, 112, 32)
    rec = {"lin": [], "ratios": []}
    real_refine = jheur._refine_device
    real_diffmap = jba.butteraugli_diffmap_jax
    real_ratio = jheur._refine_ratio

    def refine(state, *args):
        rec["args"] = (copy.deepcopy(state),) + copy.deepcopy(args)
        real_refine(state, *args)
        rec["field"] = state.raw_quant_field.copy()

    def diffmap(lin, orig, **kw):
        rec["lin"].append(np.asarray(lin))
        return real_diffmap(lin, orig, **kw)

    def ratio(berr, target):
        r = real_ratio(berr, target)
        rec["ratios"].append(r)
        return r

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtc, "accelerator_available", lambda: True)
        mp.setattr(jheur, "_refine_device", refine)
        mp.setattr(jba, "butteraugli_diffmap_jax", diffmap)
        mp.setattr(jheur, "_refine_ratio", ratio)
        jcs.encode_lossy(img, distance=1.0, effort=7, device=True)
    assert len(rec["lin"]) == len(rec["ratios"]) == rec["args"][11] == 2
    return rec


def _port_refine(rec, monkeypatch):
    """The port's _refine_device on the JAX call's arguments, on the CPU:
    (its trial image of each round, the field it leaves)."""
    lins = []
    real = tba.butteraugli_diffmap_torch

    def diffmap(lin, orig, **kw):
        lins.append(lin.numpy().copy())
        return real(lin, orig, **kw)

    monkeypatch.setattr(tba, "butteraugli_diffmap_torch", diffmap)
    state, *args = copy.deepcopy(rec["args"])
    theur._refine_device(state, *args, CPU)
    return lins, state.raw_quant_field


def test_trial_matches_the_jax_package(refine_case, monkeypatch):
    """The first round's trial (quantize, dequantize, DC, IDCT8, Gaborish
    and the EPF chain through render_tail's plain twin, linear RGB) on the
    same field."""
    lins, _ = _port_refine(refine_case, monkeypatch)
    ref = refine_case["lin"][0]
    assert lins[0].shape == ref.shape and lins[0].dtype == np.float32
    np.testing.assert_allclose(lins[0], ref, rtol=0, atol=1e-5)


def test_refined_field_matches_the_jax_package(refine_case, monkeypatch):
    _, field = _port_refine(refine_case, monkeypatch)
    ref = refine_case["field"]
    assert field.dtype == ref.dtype and field.shape == ref.shape
    qf = refine_case["args"][9].astype(np.float64)
    near = np.zeros(ref.shape, dtype=bool)
    for r in refine_case["ratios"]:
        qf = np.clip(qf * r, 1.0, QUANT_MAX)
        near |= np.abs(qf - np.floor(qf) - 0.5) < BOUNDARY
    np.testing.assert_array_equal(np.clip(np.round(qf), 1, QUANT_MAX), ref)
    differ = field != ref
    assert not (differ & ~near).any(), np.argwhere(differ & ~near)


def _patches_args():
    rng = np.random.default_rng(5)
    base = np.clip(np.full((96, 120, 3), 200.0)
                   + rng.normal(0, 3, (96, 120, 3)), 0, 255).astype(np.uint8)
    sheet = np.zeros((24, 24, 3), np.uint8)
    sheet[4:20, 4:20] = (40, 180, 90)
    return (base, sheet, [(0, 0, 24, 24, [(30, 10), (80, 60)])])


def _frames():
    rng = np.random.default_rng(2)
    return [np.clip(photo(64, 80, 40 + i).astype(float)
                    + rng.normal(0, 4, (64, 80, 3)), 0, 255).astype(np.uint8)
            for i in range(3)]


# (entry, positional arguments, keywords): effort 4 (tiles up to 16 px),
# the default 5 on a two-group image, 7 (the refinement), a preview frame
# of an e3 encode (its own strategy search), an animation and a patch
# dictionary (both run the full ladder)
ENCODES = {
    "e4": ("encode_lossy", lambda: (photo(72, 88, 34),), dict(effort=4)),
    "e5": ("encode_lossy", lambda: (photo(136, 264, 35),), dict(effort=5)),
    "e7": ("encode_lossy", lambda: (photo(112, 96, 36),), dict(effort=7)),
    "e3-preview": ("encode_lossy", lambda: (photo(128, 160, 37),),
                   dict(effort=3, preview=64)),
    "animation": ("encode_animation", lambda: (_frames(),),
                  dict(lossless=False)),
    "patches": ("encode_with_patches", _patches_args, {}),
}


@pytest.mark.parametrize("case", sorted(ENCODES))
def test_device_cpu_writes_the_jax_device_bytes(case, jax_device):
    entry, args, kw = ENCODES[case]
    args = args()
    jkw = dict(kw, device=True) if entry == "encode_lossy" else kw
    ref = getattr(jcs, entry)(*args, distance=1.0, **jkw)
    before = launch_counts()
    got = getattr(tcs, entry)(*args, distance=1.0, device="cpu", **kw)
    # the CPU takes the plain twins; the patches encode decodes its sheet
    # frame, whose AC-global section is read in C
    assert {k: n - before.get(k, 0) for k, n in launch_counts().items()
            if n != before.get(k, 0)} == (
        {"ac_global_native": 1} if case == "patches" else {})
    assert got == ref


@pytest.mark.parametrize("case", sorted(ENCODES))
def test_device_none_writes_the_jax_host_bytes(case):
    entry, args, kw = ENCODES[case]
    args = args()
    jkw = dict(kw, device=False) if entry == "encode_lossy" else kw
    ref = getattr(jcs, entry)(*args, distance=1.0, **jkw)
    assert getattr(tcs, entry)(*args, distance=1.0, device=None, **kw) == ref


def test_device_stages_run_on_the_given_device(monkeypatch):
    """encode_lossy at e7 with device="cpu": every tile cost of the search
    and every refinement round take the torch forms on that device, and
    nothing takes the host loop."""
    seen = {"tile": [], "refine": [], "host_diffmap": 0}
    real_tile = tframe._tile_cost_device
    real_refine = theur._refine_device

    def tile(*args):
        seen["tile"].append(args[-1])
        return real_tile(*args)

    def refine(*args):
        seen["refine"].append(args[-1])
        return real_refine(*args)

    def host_diffmap(*args):
        seen["host_diffmap"] += 1

    monkeypatch.setattr(tframe, "_tile_cost_device", tile)
    monkeypatch.setattr(theur, "_refine_device", refine)
    monkeypatch.setattr(theur, "_perceptual_diffmap", host_diffmap)
    tcs.encode_lossy(photo(96, 96, 38), distance=1.0, effort=7,
                     device="cpu")
    assert len(seen["tile"]) == 10 and set(seen["tile"]) == {CPU}
    assert seen["refine"] == [CPU] and seen["host_diffmap"] == 0


ENTRIES = {
    "encode_lossy e4": lambda img: tcs.encode_lossy(img, effort=4),
    "encode_lossy e5": lambda img: tcs.encode_lossy(img),
    "encode_lossy e7": lambda img: tcs.encode_lossy(img, effort=7),
    "encode_lossy e3 preview": lambda img: tcs.encode_lossy(
        img, effort=3, preview=32),
    "encode_animation": lambda img: tcs.encode_animation(
        [img, img], lossless=False),
    "encode_with_patches": lambda img: tcs.encode_with_patches(
        img, img[:16, :16], [(0, 0, 16, 16, [(8, 8)])]),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_cuda_default_raises_without_a_card(entry):
    """"cuda", the default, raises where the encode runs a device stage;
    a featured e3 encode and a lossless animation never ask for one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device path runs there")
    img = photo(48, 64, 39)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRIES[entry](img)
    assert tcs.encode_lossy(img, effort=3, stats={})
    assert tcs.encode_animation([img, img])
