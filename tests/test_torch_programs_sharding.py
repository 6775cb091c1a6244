"""The sharded builders' programs (parallel/sharding.py, ops/programs.py)
on the CPU, with the CUDA graph stubbed (tests/test_torch_programs.py's
stub_capture) and every mesh entry's programs taken to cuda:0's cache:
each builder on a mesh of 4 entries, called three times (eager, capture
and replay, replay), gives its eager output bitwise each time, the
output of the same builder run directly on the CPU, and the JAX
builder's output within tests/test_torch_sharding.py's bounds; every
program of the builder (a phase a mesh entry) then replays.
decode_batch_sharded runs its entries through the "batch" program,
which the four entries of one geometry share.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from test_sharded_full import _inputs
from test_torch_programs import CUDA0, stub_capture  # noqa: F401
from test_torch_sharding import (_block_inputs, _encode_inputs,
                                 _jax_full_xyb, _jmesh, _rgb_tol,
                                 serving_streams, stream_512)  # noqa: F401

from libjxl_tpu.api import tpu_codec as jtc
from libjxl_tpu.parallel import sharding as js
from libjxl_tpu_torch.api import tpu_codec as ttc
from libjxl_tpu_torch.ops import programs
from libjxl_tpu_torch.parallel import dryrun
from libjxl_tpu_torch.parallel import sharding as ts
from libjxl_tpu_torch.vardct import streaming
from libjxl_tpu_torch.vardct.quant_weights import library_tables


def _three_on_card(monkeypatch, run, *args):
    """run(*args) three times with programs.run on cuda:0's cache (stubbed
    graphs, bodies on the CPU): the three outputs, every one equal to the
    first bitwise."""
    real = programs.run

    def on_card(name, key, fn, *a, device, **kw):
        return real(name, key, fn, *a, device=CUDA0, **kw)

    monkeypatch.setattr(programs, "run", on_card)
    outs = [run(*args) for _ in range(3)]
    monkeypatch.setattr(programs, "run", real)
    for out in outs[1:]:
        _assert_equal(out, outs[0])
    return outs


def _assert_equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _replaying(name, n):
    progs = [p for p in programs.programs(CUDA0) if p.name == name]
    assert len(progs) == n
    assert all(p.mode == "replay" for p in progs), [
        (p.key, p.mode) for p in progs]
    return progs


@pytest.mark.parametrize("epf_iters", [2, 3])
def test_sharded_full_decode_programs(stub_capture, monkeypatch,
                                      epf_iters):
    args = _inputs()
    mesh = ts.Mesh.of("cpu", 4, batch=2)
    outs = _three_on_card(monkeypatch, ts.build_sharded_decode_full(
        mesh, epf_iters=epf_iters), *args)
    progs = {p.key[-2:]: p for p in _replaying("sharded_full", 8)}
    # phase 2 reads each entry's rows where its phase 1 writes them
    for entry in ((0, 0), (0, 1), (1, 0), (1, 1)):
        assert any(slot is progs[1, entry].out
                   for slot in progs[2, entry].slots)
    direct = ts.build_sharded_decode_full(mesh, epf_iters=epf_iters)(*args)
    _assert_equal(outs[0], direct)
    ref = np.asarray(js.build_sharded_decode_full(
        _jmesh(4, 2), epf_iters=epf_iters)(*args))
    err = np.abs(outs[0].numpy() - ref)
    assert (err <= _rgb_tol(_jax_full_xyb(*args, epf_iters), ref)).all()


def test_sharded_stream_render_programs(stub_capture, monkeypatch,
                                        stream_512):
    sr = stream_512
    mesh = ts.Mesh.of("cpu", 4)
    outs = _three_on_card(monkeypatch, sr.sharded(mesh), *sr.args)
    _replaying("sharded_stream", 8)
    _assert_equal(outs[0], sr.sharded(mesh)(*sr.args))
    ref = np.asarray(js.build_sharded_decode_stream(
        _jmesh(4, 1), *sr.params)(*sr.args))
    dryrun.u8_steps(outs[0].numpy(), ref, "programs vs JAX sharded")
    np.testing.assert_array_equal(outs[0].numpy().transpose(1, 2, 0),
                                  sr.single(torch.device("cpu")).numpy())


@pytest.mark.parametrize("apply_gab", [False, True], ids=["nogab", "gab"])
def test_sharded_block_decode_programs(stub_capture, monkeypatch,
                                       apply_gab):
    args = _block_inputs(2, 16, 8, "zero", 70)
    mesh = ts.Mesh.of("cpu", 4, batch=2)
    outs = _three_on_card(monkeypatch, ts.build_sharded_decode(
        mesh, apply_gab=apply_gab), *args)
    _replaying("sharded_decode", 8 if apply_gab else 4)
    _assert_equal(outs[0], ts.build_sharded_decode(
        mesh, apply_gab=apply_gab)(*args))
    ref = np.asarray(js.build_sharded_decode(
        _jmesh(4, 2), apply_gab=apply_gab)(*args))
    np.testing.assert_allclose(outs[0].numpy(), ref, rtol=1e-5, atol=1e-3)


def test_sharded_encode_programs(stub_capture, monkeypatch):
    args = _encode_inputs(2, 16, 8, 9)
    mesh = ts.Mesh.of("cpu", 4, batch=2)
    outs = _three_on_card(monkeypatch, ts.build_sharded_encode(mesh), *args)
    _replaying("sharded_encode", 4)
    _assert_equal(outs[0], ts.build_sharded_encode(mesh)(*args))
    jq, jdc = js.build_sharded_encode(_jmesh(4, 2))(*args)
    _assert_equal(outs[0], (jq, jdc))


def test_sharded_chunk_step_programs(stub_capture, monkeypatch):
    rng = np.random.default_rng(4)
    xyb = rng.normal(0, 0.1, (3, 256, 64)).astype(np.float32)
    dm_inv, dm = (t.astype(np.float32) for t in library_tables()[0][::-1])
    qf = rng.integers(8, 40, (32, 8)).astype(np.int32)
    args = (xyb, dm_inv, dm, 8.716, 19.0, 1.0, 1.0, qf)
    mesh = ts.Mesh.of("cpu", 4)
    outs = _three_on_card(monkeypatch, ts.make_sharded_chunk_step(mesh),
                          *args)
    _replaying("sharded_chunk", 4)
    _assert_equal(outs[0], streaming.step(*args, torch.device("cpu")))


def test_decode_batch_sharded_runs_the_batch_program(
        stub_capture, monkeypatch, serving_streams):
    mesh = ts.Mesh.of("cpu", 4)
    outs = _three_on_card(monkeypatch, ttc.decode_batch_sharded,
                          serving_streams, mesh)
    (prog,) = _replaying("batch", 1)
    assert prog.calls == 12  # 4 entries of one geometry, 3 calls
    _assert_equal(outs[0], ttc.decode_batch(serving_streams, device="cpu"))
    ref = jtc.decode_tpu_batch_sharded(serving_streams, mesh=JMesh(
        np.array(jax.devices()[:4]), ("batch",)))
    for g, r in zip(outs[0], ref):
        assert np.abs(g.astype(int) - np.asarray(r).astype(int)).max() <= 1
