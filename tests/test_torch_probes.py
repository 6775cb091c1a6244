"""libjxl_tpu_torch/probes against the TPU gather probes S1-S7 on the CPU.

Each probe's plain torch twin (the function a CPU tensor gets) must equal
the JAX body of its scratch/ counterpart, run through
`pl.pallas_call(..., interpret=True)`, exactly, on the inputs of
probes.gather.probe_inputs: the scratch state and a seeded one. S4 runs
through scratch/gather_bench2.make_runner itself, with the module's `pl`
swapped for an interpreting shim; S1-S3 and S5 only print a rate, so
their bodies are restated from the cited lines; S6 compares row 0, the
only row its no-op kernel writes. S7's stream-copy floor is held to the
stream words of the JAX serve plan of tests/test_ans_kernel.py's two
512^2 d4 streams, read as prof_kernel.py's glue reads them.
tests/test_torch_cuda.py holds the CUDA kernels to the twins on a card.
"""

import functools
import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libjxl_tpu.api import codestream
from libjxl_tpu.ops import ans_kernel as jak
from libjxl_tpu_torch.base.device import launch_counts
from libjxl_tpu_torch.ops import ans_kernel as tak
from libjxl_tpu_torch.probes import gather, prof_kernel
from tests.test_ans_kernel import _image, _plan_for

SCRATCH = pathlib.Path(__file__).resolve().parents[1] / "scratch"
SHAPE = (8, 128)
ITERS = 12
SEEDS = (None, 5)  # the scratch state, and random words


def _interpret(kernel, out_shape, dtype, *args):
    """The TPU probe's kernel body through pallas_call in interpret mode."""
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, dtype),
        interpret=True)(*map(jnp.asarray, args)))


def _twin(fn, arrays, **kw):
    out = fn(**gather.as_tensors(arrays, "cpu"), **kw)
    return out.numpy()


def _bits(a):
    return np.asarray(a).view(np.int32)


def _scratch_module(name):
    spec = importlib.util.spec_from_file_location(f"scratch_{name}",
                                                  SCRATCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _golden_table(n, mod):
    """The scratch construction: arange * 2654435761 % mod in u32."""
    return np.asarray((jnp.arange(n, dtype=jnp.uint32)
                       * jnp.uint32(2654435761)) % jnp.uint32(mod))


# S1: scratch/gather_bench.py:61-74 -----------------------------------------

@pytest.mark.parametrize("table_size,gathers", [(512, 1), (8192, 3)])
def test_bench_pallas_gather_twin_matches_jax(table_size, gathers):
    for seed in SEEDS:
        arrays = gather.probe_inputs("bench_pallas_gather", seed,
                                     table_size=table_size)
        np.testing.assert_array_equal(arrays["table"],
                                      _golden_table(table_size, table_size))

        def kernel(tbl_ref, st_ref, out_ref):
            tbl = tbl_ref[:]

            def body(i, s):
                for _ in range(gathers):
                    idx = (s >> 4) % table_size
                    s = s + jnp.take(tbl, idx.reshape(-1),
                                     axis=0).reshape(SHAPE)
                return (s * 5 + 7)

            out_ref[:] = jax.lax.fori_loop(0, ITERS, body, st_ref[:])

        ref = _interpret(kernel, SHAPE, jnp.uint32, arrays["table"],
                         arrays["state"])
        got = _twin(gather.bench_pallas_gather, arrays, iters=ITERS,
                    gathers=gathers)
        np.testing.assert_array_equal(got, _bits(ref))


# S2: scratch/gather_bench.py:95-112 ----------------------------------------

def test_bench_pallas_2d_gather_twin_matches_jax():
    table_size = 8192
    for seed in SEEDS:
        arrays = gather.probe_inputs("bench_pallas_2d_gather", seed,
                                     table_size=table_size)
        np.testing.assert_array_equal(
            arrays["table"],
            _golden_table(table_size, table_size).reshape(64, 128))

        def kernel(tbl_ref, st_ref, out_ref):
            tbl = tbl_ref[:]

            def body(i, s):
                idx = (s >> 4) % table_size
                r = idx // 128
                c = idx % 128
                v = tbl[r, c]
                return (s + v) * 5 + 7

            out_ref[:] = jax.lax.fori_loop(0, ITERS, body, st_ref[:])

        ref = _interpret(kernel, SHAPE, jnp.uint32, arrays["table"],
                         arrays["state"])
        got = _twin(gather.bench_pallas_2d_gather, arrays, iters=ITERS)
        np.testing.assert_array_equal(got, _bits(ref))


# S3: scratch/gather_bench.py:132-146 ---------------------------------------

def test_bench_pallas_onehot_window_twin_matches_jax():
    win = 64
    for seed in SEEDS:
        arrays = gather.probe_inputs("bench_pallas_onehot_window", seed,
                                     win=win)
        np.testing.assert_array_equal(
            arrays["window"], _golden_table(win * 1024, 997).reshape(
                win, *SHAPE))

        def kernel(win_ref, st_ref, out_ref):
            w = win_ref[:]

            def body(i, s):
                idx = (s >> 4) % win
                ks = jax.lax.broadcasted_iota(jnp.uint32, (win, 8, 128), 0)
                sel = jnp.where(ks == idx[None], w, 0).sum(axis=0)
                return (s + sel) * 5 + 7

            out_ref[:] = jax.lax.fori_loop(0, ITERS, body, st_ref[:])

        ref = _interpret(kernel, SHAPE, jnp.uint32, arrays["window"],
                         arrays["state"])
        got = _twin(gather.bench_pallas_onehot_window, arrays, iters=ITERS)
        np.testing.assert_array_equal(got, _bits(ref))


# S4: scratch/gather_bench2.py make_runner with main()'s bodies (:62-180) ----

def _lookup1024(tbl, idx):
    r = idx >> 7
    c = idx & 127
    acc = jnp.zeros(SHAPE, jnp.int32)
    for k in range(8):
        rowk = jnp.broadcast_to(tbl[k:k + 1, :], SHAPE)
        g = jnp.take_along_axis(rowk, c, axis=1)
        acc = jnp.where(r == k, g, acc)
    return acc


def _kA(it, tbl_ref, st_ref, out_ref):
    tbl = tbl_ref[:]

    def body(i, s):
        idx = (s + i) & 63
        g = jnp.take_along_axis(tbl, jnp.tile(idx, (8, 1)), axis=0)
        return s + g[:8, :]

    out_ref[:] = jax.lax.fori_loop(0, it, body, st_ref[:])


def _take_along_body(mask, axis):
    def kernel(it, tbl_ref, st_ref, out_ref):
        tbl = tbl_ref[:]

        def body(i, s):
            idx = (s + i) & mask
            return s + jnp.take_along_axis(tbl, idx, axis=axis)

        out_ref[:] = jax.lax.fori_loop(0, it, body, st_ref[:])

    return kernel


def _kC(it, tbl_ref, st_ref, out_ref):
    tbl = tbl_ref[:]

    def body(i, s):
        return s + _lookup1024(tbl, (s + i) & 1023)

    out_ref[:] = jax.lax.fori_loop(0, it, body, st_ref[:])


def _kD(it, st_ref, out_ref):
    def body(i, s):
        x = s
        for _ in range(16):
            x = (x * 5 + 7) ^ (x >> 3)
            x = x + (x << 2)
        return x

    out_ref[:] = jax.lax.fori_loop(0, it, body, st_ref[:])


def _kF(it, tbl_ref, win_ref, st_ref, out_ref):
    tbl = tbl_ref[:]
    win = win_ref[:]

    def body(i, s):
        x = s
        x = x + _lookup1024(tbl, (x + i) & 1023)
        x = x ^ _lookup1024(tbl, (x * 3 + 1) & 1023)
        x = x + jnp.take_along_axis(win, x & 7, axis=0)
        for _ in range(20):
            x = (x * 5 + 7) ^ (x >> 3)
        return x

    out_ref[:] = jax.lax.fori_loop(0, it, body, st_ref[:])


S4_BODIES = {"kA": _kA, "kA2": _take_along_body(63, 0),
             "kB": _take_along_body(127, 1), "kC": _kC, "kD": _kD,
             "kE": _take_along_body(7, 0), "kF": _kF}


@pytest.fixture(scope="module")
def gather_bench2():
    return _scratch_module("gather_bench2")


@pytest.mark.parametrize("body", gather.BODIES)
def test_make_runner_twin_matches_jax(body, gather_bench2, monkeypatch):
    monkeypatch.setattr(gather_bench2, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    tbl_a = (np.arange(64 * 128, dtype=np.int32) % 1000).reshape(64, 128)
    tbl_b = (np.arange(8 * 128, dtype=np.int32) % 1000).reshape(SHAPE)
    for seed in SEEDS:
        arrays = gather.probe_inputs("make_runner", seed, body=body)
        tables = [arrays[k] for k in ("tbl", "win") if k in arrays]
        scratch_tables = {"kA": [tbl_a], "kA2": [tbl_a], "kD": [],
                          "kF": [tbl_b, tbl_b]}.get(body, [tbl_b])
        for a, b in zip(tables, scratch_tables, strict=True):
            np.testing.assert_array_equal(a, b)
        run = gather_bench2.make_runner(S4_BODIES[body], len(tables) + 1,
                                        ITERS)(ITERS)
        ref = np.asarray(run(*map(jnp.asarray, tables),
                             jnp.asarray(arrays["state"])))
        got = _twin(gather.run_form_plain, arrays, body=body, iters=ITERS)
        np.testing.assert_array_equal(got, ref)
        if seed is None:
            np.testing.assert_array_equal(
                arrays["state"], np.arange(1024, dtype=np.int32).reshape(
                    SHAPE))


# S5: scratch/gather_bench3.py:22-34 with the shapes of :66-79 --------------

@pytest.mark.parametrize("case", range(len(gather.PROBE_CASES)),
                         ids=[c[0] for c in gather.PROBE_CASES])
def test_probe_twin_matches_jax(case):
    _, shape, axis, idx_mod, _ = gather.PROBE_CASES[case]
    iters = 4
    for seed in SEEDS:
        arrays = gather.probe_inputs("probe", seed, case=case)
        n = int(np.prod(shape))
        np.testing.assert_array_equal(
            arrays["table"], (np.arange(n) % 997).reshape(shape))
        if seed is None:
            np.testing.assert_array_equal(
                arrays["state"], (np.arange(n) % idx_mod).reshape(shape))

        def kernel(tbl_ref, st_ref, out_ref):
            tbl = tbl_ref[:]

            def body(i, s):
                idx = (s + i) % idx_mod
                g = jnp.take_along_axis(tbl, idx, axis=axis)
                return s + g

            out_ref[:] = jax.lax.fori_loop(0, iters, body, st_ref[:])

        ref = _interpret(kernel, shape, jnp.int32, arrays["table"],
                         arrays["state"])
        got = _twin(gather.probe, arrays, iters=iters, axis=axis,
                    idx_mod=idx_mod)
        np.testing.assert_array_equal(got, ref)


# S6: scratch/gather_forms.py:107-125 ---------------------------------------

def test_wl_pallas_twin_matches_jax():
    def nk(a_ref, o_ref):
        o_ref[0] = a_ref[0]

    @jax.jit
    def wl_pallas(a):
        def body(c):
            it, acc = c
            r = pl.pallas_call(
                nk, out_shape=jax.ShapeDtypeStruct(gather.WL_SHAPE,
                                                   jnp.int32),
                interpret=True)(acc)
            return (it + 1, r)

        return jax.lax.while_loop(lambda c: c[0] < gather.WL_CALLS, body,
                                  (jnp.int32(0), a))[1]

    for seed in SEEDS:
        a = gather.probe_inputs("wl_pallas", seed)["a"]
        assert a.shape == gather.WL_SHAPE
        ref = np.asarray(wl_pallas(jnp.asarray(a)))
        got = gather.wl_pallas(torch.from_numpy(a)).numpy()
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[0], a[0])


# S7: scratch/prof_kernel.py:88-116 -----------------------------------------

@pytest.fixture(scope="module")
def serve_plan():
    """tests/test_ans_kernel.py's two 512^2 d4 streams as the JAX serve
    plan, and the port's lane plan of it."""
    datas = [codestream.encode_lossy(_image(512, s), distance=4.0,
                                     effort=3) for s in (7, 8)]
    sp = jak.build_serve_plan(_plan_for(datas))
    return sp, tak.lane_plan_from_serve_plan(sp)


def _glue_words(sp, iters):
    """Row 0 of each of `iters` no-op chunks of prof_kernel.py's glue: the
    lane's window gathered at awp (clamped to the last halfword), packed to
    32-bit words, first word; awp moves 2 halfwords an iteration. [iters,
    lanes] int32."""
    flat = jnp.asarray(sp.flat_hw)
    total = flat.shape[0]
    awp = (jnp.asarray(sp.lane_off[:sp.n_lanes].astype(np.int32))[None, :]
           + 2 * jnp.arange(iters, dtype=jnp.int32)[:, None])
    win = [jnp.take(flat, jnp.minimum(awp + k, total - 1),
                    axis=0).astype(jnp.int32) for k in (0, 1)]
    return np.asarray(win[0] | (win[1] << 16))


def test_glue_twin_matches_serve_plan_words(serve_plan):
    sp, lp = serve_plan
    L = lp.n_lanes
    rng = np.random.default_rng(9)
    # a lane at no step, one at every step, the rest in between
    steps = rng.integers(0, lp.t_alloc + 1, L).astype(np.int32)
    steps[0], steps[1] = 0, lp.t_alloc
    lt = lp.to("cpu")
    n = prof_kernel.GLUE_LAUNCHES.count
    tape, ok = prof_kernel.glue(lt, torch.from_numpy(steps))
    assert prof_kernel.GLUE_LAUNCHES.count == n  # the twin launches none
    tape = tape.numpy()
    assert tape.shape == (lp.t_alloc, L) and ok.all()
    # step 0 is the state preload (2 halfwords before the JAX lane
    # offset); step t + 1 is the glue's word of iteration t
    flat = sp.flat_hw.astype(np.int64)
    pre = flat[lp.lane_off] | (flat[lp.lane_off + 1] << 16)
    words = _glue_words(sp, lp.t_alloc - 1)
    t = np.arange(lp.t_alloc)[:, None]
    want = np.where(t < steps[None, :],
                    np.concatenate([pre.astype(np.uint32).view(np.int32)
                                    [None], words]), 0)
    np.testing.assert_array_equal(tape, want)
    # the lane at every step reads past the end, where the read clamps
    assert lp.lane_off[1] + 2 * lp.t_alloc > len(sp.flat_hw)


# the wrappers: twins on the CPU, kernels or an error elsewhere --------------

@pytest.mark.parametrize("form", gather.FORMS, ids=lambda f: f.name)
def test_form_runs_twin_on_cpu_and_refuses_other_devices(form):
    counts = launch_counts()
    t = form.tensors("cpu", seed=3)
    got = form(t, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  form(t, 3, plain=True).numpy())
    with pytest.raises(ValueError, match="device meta"):
        form({k: v.to("meta") for k, v in t.items()}, 3)
    assert launch_counts() == counts


def test_wl_pallas_and_glue_refuse_other_devices(serve_plan):
    a = gather.as_tensors(gather.probe_inputs("wl_pallas"), "meta")["a"]
    counts = launch_counts()
    with pytest.raises(ValueError, match="device meta"):
        gather.wl_pallas(a)
    with pytest.raises(ValueError, match="device meta"):
        gather.WlPallasGraph(a)
    _, lp = serve_plan
    lt = lp.to("meta")
    with pytest.raises(ValueError, match="device meta"):
        prof_kernel.glue(lt, torch.zeros(lp.n_lanes, dtype=torch.int32,
                                         device="meta"))
    assert launch_counts() == counts
