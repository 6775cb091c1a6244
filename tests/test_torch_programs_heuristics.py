"""The encoder heuristics' programs (ops/programs.py) on the CPU: the
"tile_cost", "trial" and "diffmap" programs' keys against the JAX
package's static keys on the same calls, and an effort-7 encode's program
cycle with the CUDA graph stubbed (tests/test_torch_programs.py's
stub_capture): a second encode of one geometry replays every program, its
bytes equal the first encode's and the eager route's, and the cache keeps
all of them at programs.CACHE_SIZE (16, the bound before it, evicts each
before its reuse).

The JAX keys: _TILE_COST_JIT's static arguments (rows, cols, tby, tbx),
_TRIAL_JIT's (gab_on, epf_iters), butteraugli_diffmap_jax's
(hf_asymmetry, xmul, intensity_target), read from the JAX package's own
calls with its jitted functions replaced by recorders.
"""

import copy
import inspect

import numpy as np
import pytest
import torch
from test_torch_heuristics import LADDER, acs_inputs, refine_case  # noqa: F401
from test_torch_programs import CUDA0, stub_capture  # noqa: F401

from libjxl_tpu.metrics import butteraugli_jax as jba
from libjxl_tpu.vardct import frame as jframe
from libjxl_tpu.vardct import heuristics as jheur
from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.metrics import butteraugli_torch as tba
from libjxl_tpu_torch.ops import programs
from libjxl_tpu_torch.vardct import ac_strategy as acs
from libjxl_tpu_torch.vardct import frame as tframe
from libjxl_tpu_torch.vardct import heuristics as theur

CPU = torch.device("cpu")
HEURISTICS = ("tile_cost", "trial", "diffmap")


def _port_keys(monkeypatch, fn, *args, **kw):
    """fn(*args, **kw) on the CPU with programs.run recording the (name,
    key) of every call."""
    seen = []
    real = programs.run

    def recording(name, key, body, *a, **k):
        seen.append((name, key))
        return real(name, key, body, *a, **k)

    monkeypatch.setattr(programs, "run", recording)
    fn(*args, **kw)
    monkeypatch.setattr(programs, "run", real)
    return seen


@pytest.mark.parametrize("rows,cols,strategy", LADDER,
                         ids=[f"{r}x{c}" for r, c, _ in LADDER])
def test_tile_cost_key_is_the_jax_key(acs_inputs, monkeypatch, rows,
                                      cols, strategy):
    jstate, jxyb = copy.deepcopy(acs_inputs["jax"])
    tstate, txyb = copy.deepcopy(acs_inputs["port"])
    kind = acs.QUANT_TABLE[strategy]
    nby, nbx = jstate.fd.ysize_blocks, jstate.fd.xsize_blocks
    tby, tbx = nby // (rows // 8), nbx // (cols // 8)
    jkeys = []

    def jit(*args, rows, cols, tby, tbx):
        jkeys.append((rows, cols, tby, tbx))
        return np.zeros((tby, tbx), np.float32)

    monkeypatch.setattr(jframe, "_TILE_COST_JIT", jit)
    jframe._tile_cost_device(jstate, jxyb, rows, cols, kind, tby, tbx)
    keys = _port_keys(monkeypatch, tframe._tile_cost_device, tstate, txyb,
                      rows, cols, kind, tby, tbx, CPU)
    assert keys == [("tile_cost", k) for k in jkeys]
    assert len(keys) == 1


@pytest.mark.parametrize("epf_iters", [0, 1, 2, 3])
@pytest.mark.parametrize("gab_on", [True, False], ids=["gab", "nogab"])
def test_trial_and_diffmap_keys_are_the_jax_keys(refine_case, monkeypatch,
                                                 gab_on, epf_iters):
    """The refinement of refine_case's arguments with the frame's Gaborish
    and EPF set otherwise: each round's trial at _TRIAL_JIT's static key,
    its diffmap at butteraugli_diffmap_jax's."""
    state, *args = copy.deepcopy(refine_case["args"])
    if not gab_on:
        args[5] = None          # gab
    args[6].epf_iters = epf_iters  # lf
    shape = args[7].shape       # xyb_orig
    jkeys = []

    def trial(*a, gab_on, epf_iters):
        jkeys.append(("trial", (gab_on, epf_iters)))
        return np.zeros(shape, np.float32)

    static = ("hf_asymmetry", "xmul", "intensity_target")
    params = inspect.signature(jba.butteraugli_diffmap_jax).parameters

    def diffmap(lin, orig, **kw):
        jkeys.append(("diffmap", tuple(kw.get(n, params[n].default)
                                       for n in static)))
        return np.zeros(shape[1:], np.float32)

    monkeypatch.setattr(jheur, "_TRIAL_JIT", trial)
    monkeypatch.setattr(jba, "butteraugli_diffmap_jax", diffmap)
    jheur._refine_device(copy.deepcopy(state), *copy.deepcopy(args))
    keys = _port_keys(monkeypatch, theur._refine_device, state, *args, CPU)
    assert keys == jkeys
    assert [k[0] for k in keys] == ["trial", "diffmap"] * args[10]


@pytest.mark.parametrize("kw", [{}, dict(hf_asymmetry=1.2),
                                dict(xmul=0.5, intensity_target=250.0)],
                         ids=["defaults", "hf_asymmetry", "xmul-intensity"])
def test_diffmap_key_is_the_jax_key(monkeypatch, kw):
    """butteraugli_diffmap_torch's key is the JAX function's static
    arguments as a call binds them, and the program's map is the direct
    body's."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (3, 24, 40)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.02, a.shape), 0, 1).astype(np.float32)
    bound = inspect.signature(jba.butteraugli_diffmap_jax).bind(a, b, **kw)
    bound.apply_defaults()
    jkey = tuple(bound.arguments[n]
                 for n in ("hf_asymmetry", "xmul", "intensity_target"))
    got = []
    keys = _port_keys(monkeypatch, lambda: got.append(
        tba.butteraugli_diffmap_torch(torch.from_numpy(a),
                                      torch.from_numpy(b), **kw)))
    assert keys == [("diffmap", jkey)]
    with torch.inference_mode():
        ref = tba._diffmap(torch.from_numpy(a), torch.from_numpy(b), *jkey)
    assert torch.equal(got[0], ref)


def _smooth(n, seed):
    """A smooth photo-like n x n image: its 128^2 areas are flat enough
    for the 128 and 256 rungs, so an effort-7 search runs all 16 tile
    sizes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    img = np.stack([60 + 120 * xx / n + 20 * np.sin(yy / 50.0),
                    90 + 80 * yy / n, 150 - 60 * xx / n], -1)
    return np.clip(img + rng.normal(0, 0.5, img.shape), 0,
                   255).astype(np.uint8)


def _on_card(monkeypatch):
    """programs.run with a CPU device taken to cuda:0's cache (the graph
    stubbed, the bodies on the CPU); returns the list of (name, key) it
    is called with."""
    calls = []
    real = programs.run

    def run(name, key, fn, *args, device, **kw):
        calls.append((name, key))
        return real(name, key, fn, *args, device=CUDA0, **kw)

    monkeypatch.setattr(programs, "run", run)
    return calls


def _encode(img):
    return tcs.encode_lossy(img, distance=1.0, effort=7, device="cpu")


def test_e7_encodes_of_one_geometry_replay_every_program(stub_capture,
                                                         monkeypatch):
    img = _smooth(256, 41)
    eager = _encode(img)
    calls = _on_card(monkeypatch)
    first = _encode(img)
    n_first = len(calls)
    progs = {(p.name, p.key): p for p in programs.programs(CUDA0)}
    replays = {k: p.graph.replays if p.graph else 0
               for k, p in progs.items()}
    second = _encode(img)
    assert first == second == eager
    # 16 tile sizes once an encode, the trial and the diffmap once a
    # refinement round (2 at e7)
    assert calls[:n_first] == calls[n_first:]
    names = [name for name, _ in calls[:n_first]]
    assert names.count("tile_cost") == 16
    assert names.count("trial") == names.count("diffmap") == 2
    assert len(set(calls)) == 18 <= programs.CACHE_SIZE
    progs = {(p.name, p.key): p for p in programs.programs(CUDA0)}
    assert set(progs) == set(calls)
    for k, p in progs.items():
        assert k[0] in HEURISTICS and p.mode == "replay"
        assert p.graph.replays > replays.get(k, 0), k


def test_the_old_cache_bound_evicts_every_program_before_its_reuse(
        stub_capture, monkeypatch):
    """At 16 programs a device, the bound before an effort-7 encode's 18,
    the cycle evicts each program before its next call: in a second
    encode of the geometry no tile size is captured, and the trial and
    the diffmap are made anew (their second round captures them again)."""
    monkeypatch.setattr(programs, "CACHE_SIZE", 16)
    img = _smooth(256, 42)
    calls = _on_card(monkeypatch)
    first = _encode(img)
    assert len(set(calls)) == 18
    assert _encode(img) == first
    progs = programs.programs(CUDA0)
    assert all(p.graph is None for p in progs if p.name == "tile_cost")
    assert sorted(p.calls for p in progs
                  if p.name in ("trial", "diffmap")) == [2, 2]
