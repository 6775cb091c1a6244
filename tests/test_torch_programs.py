"""libjxl_tpu_torch/ops/programs.py, the program layer, on the CPU.

The port's program keys equal the keys the JAX package stores in
api/tpu_codec._BATCH_PROGS and _ENTROPY_PROGS for the same streams; calls
through the layer on the CPU equal the direct calls of the program
bodies; the cache is bounded and drops the least recently used; a call
with a timing hook runs eagerly; a program's call sequence (eager,
capture, replay), its launch counting and its output delivery, with the
CUDA graph stubbed; per-device constants are made once. The card tests
of the same layer are in tests/test_torch_cuda.py.
"""

import pathlib

import numpy as np
import pytest
import torch

from libjxl_tpu.api import tpu_codec as jtc
from libjxl_tpu_torch.api import codestream, tpu_codec
from libjxl_tpu_torch.base.device import (launch_counter, launch_counts,
                                          recording_launches)
from libjxl_tpu_torch.metrics import butteraugli_torch
from libjxl_tpu_torch.ops import ans_kernel, kernels, pipeline, programs
from libjxl_tpu_torch.parallel import sharding
from libjxl_tpu_torch.vardct import frame, heuristics, streaming
from tests.test_ans_kernel import _image

CORPUS = pathlib.Path(__file__).resolve().parent / "data" / "conformance"
CUDA0 = torch.device("cuda", 0)


def _corpus(*names):
    return [(CORPUS / f"{n}.jxl").read_bytes() for n in names]


@pytest.fixture(scope="module")
def batches():
    """The first two batches: the corpus's two all-DCT8 photos (d1 at e1
    and e3, 128x96), and tests/test_ans_kernel.py's two 512^2 d4 streams,
    which the device-entropy path takes."""
    d4 = [codestream.encode_lossy(_image(512, s), distance=4.0, effort=3,
                                  device=None) for s in (7, 8)]
    return [_corpus("lossy_photo_d1_e1", "lossy_photo_d1_e3"), d4]


def _stored_key(store, prog):
    (key,) = [k for k, p in store.items() if p is prog]
    return key


@pytest.mark.parametrize("which", [0, 1], ids=["corpus", "512-d4"])
def test_batch_key_is_the_jax_key(batches, which):
    streams = batches[which]
    prog, _ = jtc.prepare_tpu_batch(streams)
    config, args = tpu_codec.prepare_batch(streams)
    key = tpu_codec.batch_key(config, len(args[0]))
    assert key == _stored_key(jtc._BATCH_PROGS, prog)


def test_entropy_key_is_the_jax_key(batches):
    """The JAX key ends in its kernel's interpret flag, which the port
    does not have; its alias_rows is the program plan's, rounded up to
    ans_kernel.ALIAS_STEP; every other field is equal."""
    streams = batches[1]
    prog, _, sp = jtc.prepare_tpu_batch_entropy(streams)
    jkey = _stored_key(jtc._ENTROPY_PROGS, prog)
    config, _, lp = tpu_codec.prepare_batch_entropy(streams)
    key = tpu_codec.entropy_key(config, ans_kernel.program_plan(lp))
    i = len(key) - 6     # alias_rows
    assert key[:i] == jkey[:i] and key[i + 1:] == jkey[i + 1:-1]
    assert jkey[-1] is True
    step = ans_kernel.ALIAS_STEP
    assert key[i] == -(-sp.alias_rows // step) * step
    assert ans_kernel.tape_rows(lp.t_alloc) == sp.t_alloc


def _entropy_call(streams, monkeypatch):
    """The (name, key, spec) of decode_batch_entropy's program call for
    `streams` (the program's cache key), and its lane plan's arrays."""
    seen = []

    class Stop(Exception):
        pass

    def spy(name, key, fn, *args, device, mark=None, readback=False,
            **kwargs):
        seen.append(((name, key, programs.flatten((args, kwargs))[1]),
                     args[0]))
        raise Stop

    monkeypatch.setattr(programs, "run", spy)
    with pytest.raises(Stop):
        tpu_codec.decode_batch_entropy(streams, "cpu")
    return seen[0]


def test_entropy_batches_of_one_geometry_share_a_program(batches,
                                                         monkeypatch):
    """Two batches of other images of one geometry and encoder setting
    map to one "entropy" program: the padded lane streams and alias
    tables give both the same key and input shapes."""
    other = [codestream.encode_lossy(_image(512, s), distance=4.0,
                                     effort=3, device=None) for s in (9, 10)]
    key_a, lanes_a = _entropy_call(batches[1], monkeypatch)
    key_b, lanes_b = _entropy_call(other, monkeypatch)
    assert key_a == key_b
    assert not np.array_equal(lanes_a["flat_hw"], lanes_b["flat_hw"])


def test_entropy_program_equals_the_staged_route(batches):
    """decode_batch_entropy's timed route (the program's body run eagerly
    with its stages timed) gives the served call's images and the
    host-entropy batch's, exactly, and times every stage."""
    streams = batches[1]
    got, info = tpu_codec.decode_batch_entropy(streams, "cpu")
    stages = {}
    staged, _ = tpu_codec.decode_batch_entropy(streams, "cpu",
                                               stages=stages)
    assert info == {"path": "device_entropy"}
    assert tuple(stages) == tpu_codec.ENTROPY_STAGES
    for g, s, h in zip(got, staged, tpu_codec.decode_batch(streams, "cpu")):
        assert np.array_equal(g, s) and np.array_equal(g, h)


def _program_calls():
    """(program body, args, kwargs) of each program on small seeded CPU
    inputs, as the port's call sites hand them to programs.run."""
    rng = np.random.default_rng(5)
    config, args = tpu_codec.prepare_batch(
        _corpus("lossy_photo_d1_e1", "lossy_photo_d1_e3"))
    nby, nbx = 4, 6
    blocks = rng.integers(-3, 4, (3, nby, nbx, 8, 8)).astype(np.int32)
    qf = rng.integers(2, 30, (nby, nbx)).astype(np.int32)
    dc = rng.normal(0, 0.2, (3, nby, nbx)).astype(np.float32)
    cfl = rng.integers(-10, 10, (2, 1, 1)).astype(np.int32)
    dm = rng.uniform(3e-4, 0.01, (3, 8, 8)).astype(np.float32)
    igs = np.asarray(8.0, np.float32)
    isp = np.repeat(np.repeat(rng.uniform(-2.5, -0.3, (nby, nbx)), 8, 0),
                    8, 1).astype(np.float32)
    sad = np.ones((nby * 8, nbx * 8), np.float32)
    gabk = np.stack([np.eye(3, dtype=np.float32) / 3] * 3)
    srgb = rng.uniform(0, 1, (3, 32, 40)).astype(np.float32)
    blk = (blocks, qf, dc, cfl[0], cfl[1], dm, igs)
    return {
        "batch": (tpu_codec.render_batch, args, dict(config=config)),
        "dec": (kernels._pixels_program, blk,
                dict(x_dm_mult=0.8, b_dm_mult=1.0)),
        "dec_full": (kernels._render_blocks_program,
                     (*blk, gabk, isp, sad),
                     dict(x_dm_mult=1.0, b_dm_mult=1.0,
                          channel_scale=(40.0, 5.0, 3.5), epf_iters=2,
                          to_rgb=True, pass0_sigma_scale=0.9,
                          pass2_sigma_scale=6.5)),
        "enc": (tpu_codec._encode_program,
                (srgb, 1 / dm, dm, 0.125, 0.0, 1.0, 1.0),
                dict(adaptive=True, cfl=True, gab=True, distance=1.0)),
        "chunk_prep": (streaming._prep_program, (srgb,), dict(gab=True)),
        "chunk_step": (streaming._step_program,
                       (srgb, 1 / dm, dm, qf[:4, :5], 0.125, 9.0, 1.0, 1.0),
                       {}),
        **_heuristics_calls(rng, dm, gabk),
        **_sharded_calls(rng, blk, gabk),
    }


def _heuristics_calls(rng, dm, gabk):
    """The encoder heuristics' programs: a 16x8 tile size on a 32x40
    opsin image, the refinement's trial (Gaborish, two EPF passes), the
    diffmap."""
    nby, nbx = 4, 5
    dm16 = rng.uniform(3e-4, 0.01, (3, 8, 16)).astype(np.float32)
    isg = rng.uniform(-2.5, -0.3, (nby, nbx)).astype(np.float32)
    lin = rng.uniform(0, 1, (2, 3, 32, 40)).astype(np.float32)
    co = rng.normal(0, 0.05, (3, nby, nbx, 8, 8)).astype(np.float32)
    return {
        "tile_cost": (frame._tile_cost_program, (
            rng.normal(0, 0.2, (3, 32, 40)).astype(np.float32),
            rng.uniform(2, 30, (2, 5)).astype(np.float32), 1 / dm16, dm16,
            np.asarray(0.125, np.float32)),
            dict(rows=16, cols=8, tby=2, tbx=5)),
        "trial": (heuristics._trial, (
            co, co[:, :, :, 0, 0].copy(),
            rng.integers(2, 30, (nby, nbx)).astype(np.float32), dm, 1 / dm,
            np.asarray(0.125, np.float32), pipeline._consts()["inv8"], gabk,
            isg, np.ones((32, 40), np.float32)),
            dict(channel_scale=(40.0, 5.0, 3.5), pass0_sigma_scale=0.9,
                 pass2_sigma_scale=6.5, epf_iters=2)),
        "diffmap": (butteraugli_torch._diffmap, (lin[0], lin[1]),
                    dict(hf_asymmetry=0.8, xmul=1.0, intensity_target=80.0)),
    }


def _sharded_calls(rng, blk, gabk):
    """The sharded builders' phase bodies on one mesh entry's inputs:
    "<program>.<phase>" (the chunk step's body is chunk_step's)."""
    blocks, qf, dc, ytox, ytob, dm, igs = blk
    w = 48
    xyb = rng.normal(0.3, 0.1, (1, 3, 32, w)).astype(np.float32)
    sigma = rng.uniform(-2.5, -0.3, (1, 4, w // 8)).astype(np.float32)
    sad = np.ones((32, w), np.float32)
    rgb = rng.uniform(0, 1, (3, 17, 40)).astype(np.float32)
    qimg = rng.integers(-3, 4, (3, 32, w)).astype(np.int32)
    return {
        "sharded_decode.1": (sharding._hybrid_rows, blk, {}),
        "sharded_decode.2": (sharding._gab_rows,
                             (rgb[:, :1], rgb[:, 1:-1], None), {}),
        "sharded_encode": (sharding._encode_rows, (
            rng.uniform(0, 1, (1, 3, 32, w)).astype(np.float32),
            qf[None], 1 / dm, dm[1], igs,
            np.array([512.0, 64.0, 32.0], np.float32)), {}),
        "sharded_full.1": (sharding._k1_rows, (
            qimg, qf, dc, ytox, ytob, dm, np.ones(1, np.float32) * igs),
            dict(
                xdm=1.0, bdm=1.0)),
        "sharded_full.2": (sharding._full_tail, (
            xyb[:, :, :8], xyb[:, :, 8:24], xyb[:, :, 24:], sigma, sad),
            dict(top=8, rows=16, epf_iters=2)),
        "sharded_stream.2": (sharding._stream_tail, (
            None, xyb[0, :, :24], xyb[0, :, 24:], sigma[0], sad, gabk),
            dict(top=0, rows=24, channel_scale=(40.0, 5.0, 3.5),
                 epf_iters=2, pass0_sigma_scale=0.9, pass2_sigma_scale=6.5)),
    }


def _equal(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def _tensors(args):
    return [torch.from_numpy(np.ascontiguousarray(a))
            if isinstance(a, np.ndarray) else a for a in args]


@pytest.mark.parametrize("name", [
    "batch", "dec", "dec_full", "enc", "chunk_prep", "chunk_step",
    "tile_cost", "trial", "diffmap", "sharded_decode.1", "sharded_decode.2",
    "sharded_encode", "sharded_full.1", "sharded_full.2",
    "sharded_stream.2"])
def test_program_on_cpu_equals_the_direct_call(name):
    """programs.run on the CPU runs the body on the plain twins and
    caches nothing."""
    fn, args, kw = _program_calls()[name]
    got = programs.run(name, (), fn, *args, device="cpu", readback=True,
                       **kw)
    with torch.inference_mode():
        direct = fn(*_tensors(args), **kw)
    if isinstance(direct, torch.Tensor):
        direct = (direct,)
        got = (got,)
    assert len(got) == len(direct)
    for g, d in zip(got, direct):
        assert isinstance(g, np.ndarray) and np.array_equal(g, d.numpy())
    assert programs.programs("cpu") == []


def test_decode_batch_on_cpu_equals_the_renderer():
    """decode_batch's "batch" program on the CPU is BatchRenderer's
    render of the same staged arrays."""
    streams = _corpus("lossy_photo_d1_e1", "lossy_photo_d1_e3")
    config, args = tpu_codec.prepare_batch(streams)
    renderer, inputs = tpu_codec.batch_from_numpy(args, config, "cpu")
    with torch.inference_mode():
        direct = tpu_codec._crop(config, renderer(*inputs).numpy())
    for got, ref in zip(tpu_codec.decode_batch(streams, "cpu"), direct):
        assert np.array_equal(got, ref)


def test_flatten_keys_statics_and_input_shapes():
    """Arrays and tensors are inputs (their shapes and dtypes in the
    spec); every other value is static and in the spec as it is."""
    a = np.zeros((2, 3), np.int16)
    t = torch.ones(4)
    tree = ((a, 0.5, [t, None]), {"k": (1, 2), "x": a})
    inputs, spec = programs.flatten(tree)
    assert [x is y for x, y in zip(inputs, (a, t, a))] == [True] * 3
    assert hash(spec) is not None
    rebuilt = programs.unflatten(spec, inputs)
    assert rebuilt[0][1] == 0.5 and rebuilt[0][2][1] is None
    assert rebuilt[1]["k"] == (1, 2) and rebuilt[1]["x"] is a
    _, other = programs.flatten(((a, 0.25, [t, None]), {"k": (1, 2),
                                                         "x": a}))
    assert other != spec
    _, shape = programs.flatten(((a[:1], 0.5, [t, None]),
                                 {"k": (1, 2), "x": a}))
    assert shape != spec
    with pytest.raises(ValueError, match="neither an input"):
        programs.flatten(({1},))


def test_cache_is_bounded_and_drops_least_recently_used():
    programs.clear()
    try:
        made = [programs.cached("p", (i,), (), CUDA0, None)
                for i in range(programs.CACHE_SIZE)]
        assert programs.cached("p", (0,), (), CUDA0, None) is made[0]
        programs.cached("p", ("new",), (), CUDA0, None)
        keys = [p.key for p in programs.programs(CUDA0)]
        assert len(keys) == programs.CACHE_SIZE
        # (1,) was the least recently used: (0,) was touched again
        assert (1,) not in keys and (0,) in keys and keys[-1] == ("new",)
        assert programs.cached("p", (1,), (), CUDA0, None) is not made[1]
        assert programs.programs("cuda:1") == []
    finally:
        programs.clear()


def test_cache_drops_programs_past_its_memory_share(stub_capture,
                                                   monkeypatch):
    """A capture that takes the memory the captured programs hold past
    held_limit drops the least recently used programs that hold memory,
    never the one just captured."""
    stub = programs.Program._capture

    def capture(self, inputs):
        stub(self, inputs)
        self.held = 4

    monkeypatch.setattr(programs.Program, "_capture", capture)
    monkeypatch.setattr(programs, "held_limit", lambda device: 10)
    x = np.zeros(2, np.float32)
    # an eager call only: the least recently used, holding nothing
    programs.run("held", (), _counting_body, x, 9.0, device=CUDA0)
    for scale in (1.0, 2.0, 3.0):
        for _ in range(2):      # eager, then capture
            programs.run("held", (), _counting_body, x, scale,
                         device=CUDA0)
    def spec(scale):
        return programs.flatten(((x, scale), {}))[1]

    left = [(p.spec, p.held) for p in programs.programs(CUDA0)]
    assert left == [(spec(9.0), 0), (spec(2.0), 4), (spec(3.0), 4)]


def test_pool_bytes_counts_the_pools_segments(monkeypatch):
    """Program.held's pool part: the segments of the graph's pool on the
    program's device, no other pool's and no other device's."""
    segments = [
        {"device": 0, "segment_pool_id": (1, 7), "total_size": 2 << 20},
        {"device": 0, "segment_pool_id": (1, 7), "total_size": 20 << 20},
        {"device": 0, "segment_pool_id": (0, 0), "total_size": 1 << 30},
        {"device": 1, "segment_pool_id": (1, 7), "total_size": 1 << 30},
        {"device": 0, "segment_pool_id": (1, 8), "total_size": 1 << 30}]
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: segments)
    assert programs._pool_bytes(CUDA0, (1, 7)) == 22 << 20


class _StubGraph:
    """Stands in for a captured CUDA graph: Program._capture runs the body
    on the slots once, records its launches, and replay reruns it."""

    def __init__(self, fn):
        self.fn, self.replays = fn, 0

    def replay(self):
        self.replays += 1
        self.fn()


@pytest.fixture
def stub_capture(monkeypatch):
    """Program._capture without CUDA: slots on the CPU (another program's
    output adopted as Program._new_slots makes them), the body run once
    under recording_launches, a _StubGraph that reruns it into the same
    output tensors (every tensor of the output tree)."""

    def capture(self, inputs):
        self.slots = self._new_slots(inputs, "cpu")
        self._load(inputs)
        args, kwargs = programs.unflatten(self.spec, self.slots)
        with recording_launches() as launches:
            self.out = self.fn(*args, **kwargs)
        self.launches = launches
        self.capture_s = 0.0

        def again():
            # a graph's replay runs no Python: its launches are counted
            # from the capture's record alone
            with recording_launches():
                fresh = self.fn(*args, **kwargs)
            for held, new in zip(programs.flatten(self.out)[0],
                                 programs.flatten(fresh)[0]):
                held.copy_(new)

        self.graph = _StubGraph(again)

    monkeypatch.setattr(programs.Program, "_capture", capture)
    monkeypatch.setattr(programs, "_on", lambda x, device: torch.from_numpy(
        np.ascontiguousarray(x)) if isinstance(x, np.ndarray)
        else x.contiguous())
    programs.clear()
    yield
    programs.clear()


def _counting_body(x, scale):
    """A body that 'launches' dequant_idct8 once a call."""
    kernels.DEQUANT_IDCT8_LAUNCHES.add()
    return x * scale


def test_program_is_eager_then_captured_then_replayed(stub_capture):
    counter = kernels.DEQUANT_IDCT8_LAUNCHES
    modes, outs = [], []
    for i in range(4):
        x = np.full(3, float(i), np.float32)
        before = counter.count
        prog = programs.cached("count", (), programs.flatten(
            ((x, 2.0), {}))[1], CUDA0, _counting_body)
        modes.append(prog.mode)
        outs.append(programs.run("count", (), _counting_body, x, 2.0,
                                 device=CUDA0))
        # every call adds one launch: the eager call itself, the capture's
        # record at its replay
        assert counter.count == before + 1
    assert modes == ["eager", "capture", "replay", "replay"]
    assert prog.graph.replays == 3 and prog.launches == {"dequant_idct8": 1}
    # each caller keeps its own output: later replays do not overwrite it
    assert [o.tolist() for o in outs] == [[2.0 * i] * 3 for i in range(4)]
    # a static value is in the key: another scale is another program
    programs.run("count", (), _counting_body, np.ones(3, np.float32), 3.0,
                 device=CUDA0)
    assert len(programs.programs(CUDA0)) == 2


def test_marked_call_runs_eager(stub_capture):
    """A call with a timing hook runs the body eagerly with mark=, and
    touches no program; the readback route returns numpy."""
    seen = []

    def body(x, mark=None):
        mark("stage", x)
        return x + 1

    for _ in range(3):
        out = programs.run("marked", (), body, np.zeros(2, np.float32),
                           device="cpu", mark=lambda s, v: seen.append(s),
                           readback=True)
        assert isinstance(out, np.ndarray) and out.tolist() == [1.0, 1.0]
    assert seen == ["stage"] * 3
    assert programs.programs(CUDA0) == []

    def no_tensor_body(v, mark=None):
        mark("stage", v)
        return torch.tensor([v])

    for _ in range(3):
        programs.run("marked", (), no_tensor_body, 4.0, device=CUDA0,
                     mark=lambda s, v: seen.append(s))
    assert seen == ["stage"] * 6 and programs.programs(CUDA0) == []


def test_recording_launches_counts_nothing():
    counter = launch_counter("dequant_idct8")
    before = launch_counts()
    with recording_launches() as rec:
        counter.add()
        counter.add(2)
        with pytest.raises(RuntimeError, match="already recording"):
            with recording_launches():
                pass
    assert rec == {"dequant_idct8": 3} and launch_counts() == before
    counter.add()
    assert counter.count == before["dequant_idct8"] + 1


def test_device_constants_are_made_once():
    """The tables a program body reads are made once a device: the same
    tensor object at a second call (a capture may not upload)."""
    a = pipeline._const("inv8", "cpu")
    assert pipeline._const("inv8", torch.device("cpu")) is a
    np.testing.assert_array_equal(a.numpy(), pipeline._consts()["inv8"])
    made = []

    def make():
        made.append(1)
        return np.arange(3, dtype=np.float32)

    t = programs.constant("test-table", "cpu", make)
    assert programs.constant("test-table", "cpu", make) is t
    assert made == [1]
    # the encode's dead-zone thresholds are such constants
    streaming._step_program(*_tensors(_program_calls()["chunk_step"][1]))
    thr = programs.constant("deadzone1", "cpu", None)
    assert programs.constant("deadzone1", "cpu", None) is thr


def _frame_state(data):
    """decode(..., device=)'s host half of `data`'s first frame: the
    entropy-decoded state and the frame header."""
    from libjxl_tpu_torch.io.bits import BitReader
    from libjxl_tpu_torch.io.frame_header import FrameHeader
    from libjxl_tpu_torch.vardct.frame import decode_vardct_frame

    r = BitReader(data)
    fh = FrameHeader(codestream.parse_codestream_header(r))
    fh.read(r)
    cap = {}

    def capture(state):
        cap["state"] = state
        state.restoration_done = state.device_output_done = True

    decode_vardct_frame(r, fh, render_fn=capture, want_qimg=True)
    return cap["state"], fh


def test_image_program_equals_the_eager_render_bitwise():
    """render_image (the "dec_image" program, the global scale as one f32
    of data) gives the bits of decode_render_image with the scale as a
    float, on a frame with dense size passes: float / tensor is
    reciprocal-times in torch, and the program's form keeps it."""
    from libjxl_tpu_torch.ops.staging import to_device

    data = (CORPUS / "lossy_photo_d0.5_e5.jxl").read_bytes()
    state, fh = _frame_state(data)
    # XYB out: an ulp that the u8 write would round away shows
    args, kw = tpu_codec.stage_image(state, fh, False)
    assert kw["size_passes"], "the e5 frame has no dense size pass"
    got = tpu_codec.render_image(args, kw, torch.device("cpu"))
    with torch.inference_mode():
        ref = pipeline.decode_render_image(*to_device(args, "cpu"),
                                           **to_device(kw, "cpu"))
    assert isinstance(args[6], float)
    assert np.array_equal(got, ref.numpy())


def test_threads_share_a_program_without_losing_a_launch(stub_capture):
    """More threads than cores call one program at once (the pipelined
    decode's worker and the streaming encode's hosts share programs):
    one eager call, one capture, replays after; every call's launch
    counted once; each caller gets its own input's output."""
    import concurrent.futures as cf
    import os
    import sys

    counter = kernels.DEQUANT_IDCT8_LAUNCHES
    before = counter.count
    calls = 4 * (os.cpu_count() or 1) * 8

    def one(i):
        x = np.full(5, float(i), np.float32)
        return i, programs.run("shared", (), _counting_body, x, 3.0,
                               device=CUDA0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cf.ThreadPoolExecutor(4 * (os.cpu_count() or 1)) as ex:
            futures = [ex.submit(one, i) for i in range(calls)]
            done, pending = cf.wait(futures, timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not pending
    for f in done:
        i, out = f.result()
        assert out.tolist() == [3.0 * i] * 5
    (prog,) = programs.programs(CUDA0)
    assert prog.calls == calls and prog.graph.replays == calls - 1
    assert counter.count == before + calls
