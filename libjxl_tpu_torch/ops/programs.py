"""The port's compiled programs: cached CUDA graphs.

The counterpart of the JAX package's jitted programs (api/tpu_codec.py's
_jitted, _jitted_sub, _BATCH_PROGS and _ENTROPY_PROGS, and
vardct/streaming.py's _jitted_chunk_step). A program is one function at
one static key on one device, dispatched as one call:

- its first call runs eagerly: the warm-up, in which the kernels build,
  the allocator settles and every per-device constant (constant()) is
  made, so a one-shot call never captures;
- its second call captures the function into a CUDA graph on a side
  stream, into the program's own memory pool, then replays it;
- later calls replay only.

run(name, key, fn, *args, device=, **kwargs) calls fn(*args, **kwargs)
through its program. The arguments form a tree of tuples, lists and
dicts. Its numpy arrays and tensors are the program's inputs: a replay
copies them into the program's input slots (a numpy array straight from
the host). Every other value in the tree is static and part of the
program's cache key, with the inputs' shapes and dtypes and the device:
a scalar that a kernel or a torch op takes by value is frozen at capture,
so it is in the key. `key` is the JAX program's static key, which the
cache keeps beside the name (tests/test_torch_programs.py holds the two
packages' keys together).

fn returns a tree of tensors. The caller gets them cloned, or read back
as numpy arrays (readback=True), while it holds the program, so that no
replay of the same program overwrites what a caller holds; clone=False
hands back the program's own output tensors, which its next call
overwrites, to a caller that consumes them first (a sharded builder
between its phases). A capture takes such an output, handed to it as an
input, as its slot: the one program reads it where the other writes it.
Each replay adds to the launch counters (base/device.py) what its
capture recorded.

A call given a `mark` timing hook runs eagerly, fn getting mark=, as
jax.disable_jit would: the measurement route. A call on the CPU runs fn
directly, on the kernels' plain twins, and caches nothing. On CUDA a
capture that fails raises; nothing falls back to an eager run. The body
of a program may not synchronize with the host or read host memory:
per-device constants come from constant(), data-dependent checks become
device flags among the outputs that the caller reads after the call.

The cache holds CACHE_SIZE programs a device and drops the least recently
used first, with its graph and its memory pool; it drops them also while
the device memory its captured programs hold (Program.held: input slots
and graph pool) passes 1 / HELD_SHARE of the card's.

While a torch profiler records, a call marks its host steps as spans
(base/device.span): jxl.program.eager (an eager call, the CPU's and a
marked call included), jxl.program.capture (the capture, with the
cache's trim after it), jxl.program.load (the copies into the input
slots), jxl.program.replay (the graph's launch and its launch counts) and
jxl.program.readback (the wait for the program's kernels and the copy of
its outputs to the host). Each is on the host, outside the captured body.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from ..base.device import launch_counter, recording_launches, span

# programs kept a device: the most one caller cycles through, an effort-7
# encode's 18 (16 tile sizes, the refinement's trial and its diffmap),
# beside the 10 that a server keeps for the other paths (batch, entropy,
# dec_image for a frame and for a strip, dec_sub, enc, chunk_prep,
# chunk_step, dec, dec_full); the held-memory bound below is the real
# guard
CACHE_SIZE = 28
# the captured programs of a device hold at most 1 / HELD_SHARE of its
# memory (a graph pool of one 16 x 2048^2 batch is 2-3 GB)
HELD_SHARE = 4

_CACHES: dict[torch.device, collections.OrderedDict] = {}
_CACHE_LOCK = threading.Lock()
# one capture at a time: torch.cuda.graph synchronizes the device as a
# capture begins
_CAPTURE_LOCK = threading.Lock()
_STREAMS: dict[torch.device, torch.cuda.Stream] = {}
_CONSTANTS: dict[tuple, torch.Tensor] = {}
_CONSTANT_LOCK = threading.Lock()


def constant(name: str, device, make) -> torch.Tensor:
    """The tensor of make()'s numpy array on `device`, made at the first
    call for (name, device) and the same tensor object after it: a
    program's capture may not upload."""
    dev = torch.device(device)
    t = _CONSTANTS.get((name, dev))
    if t is None:
        with _CONSTANT_LOCK, torch.inference_mode(False):
            t = _CONSTANTS.get((name, dev))
            if t is None:
                t = torch.from_numpy(np.ascontiguousarray(make())).to(dev)
                _CONSTANTS[(name, dev)] = t
    return t


def _is_input(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.zeros(0, dtype=x.dtype)).dtype


def flatten(tree):
    """(inputs, spec): the numpy arrays and tensors of `tree` in order,
    and its structure, hashable, with each input's shape and dtype in its
    place and every other value as it is (ValueError if unhashable)."""
    inputs = []

    def walk(x):
        if _is_input(x):
            inputs.append(x)
            return ("input", tuple(x.shape), _dtype(x))
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, tuple(walk(v) for v in x))
        if isinstance(x, dict):
            return ("dict", tuple((k, walk(v)) for k, v in x.items()))
        try:
            hash(x)
        except TypeError:
            raise ValueError(f"programs: {type(x).__name__} is neither an "
                             "input nor a hashable static value") from None
        return ("static", type(x).__name__, x)

    return inputs, walk(tree)


def unflatten(spec, inputs):
    """The tree of `spec` with `inputs` in the places of its inputs."""
    it = iter(inputs)

    def build(s):
        kind = s[0]
        if kind == "input":
            return next(it)
        if kind == "tuple":
            return tuple(build(v) for v in s[1])
        if kind == "list":
            return [build(v) for v in s[1]]
        if kind == "dict":
            return {k: build(v) for k, v in s[1]}
        return s[2]

    return build(spec)


def _host(x: np.ndarray) -> torch.Tensor:
    """x as a CPU tensor, C-contiguous (a 0-d array keeps its shape, which
    np.ascontiguousarray would make (1,))."""
    return torch.from_numpy(x if x.flags.c_contiguous
                            else np.ascontiguousarray(x))


def _on(x, device) -> torch.Tensor:
    """An input on `device`, contiguous as a slot is, so that an eager
    call computes on the layout its replays will."""
    return (_host(x) if isinstance(x, np.ndarray) else x).to(
        device).contiguous()


def _deliver(out, readback: bool, clone: bool):
    """fn's output tree with its tensors read back (numpy), cloned or as
    they are."""
    leaves, spec = flatten(out)
    if readback:
        # a copy also where the program's own tensors are on the host
        with span("jxl.program.readback"):
            leaves = [t.to("cpu", copy=clone).numpy() for t in leaves]
    elif clone:
        leaves = [t.clone() for t in leaves]
    return unflatten(spec, leaves)


def _eager(fn, spec, inputs, device, readback: bool, **extra):
    """fn on `inputs` put on `device`, run as it stands (no graph)."""
    with span("jxl.program.eager"):
        args, kwargs = unflatten(spec, [_on(x, device) for x in inputs])
        with torch.inference_mode():
            out = fn(*args, **kwargs, **extra)
        return _deliver(out, readback, clone=False)


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    with _CACHE_LOCK:
        s = _STREAMS.get(device)
        if s is None:
            s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


def _pool_bytes(device: torch.device, pool) -> int:
    """The device bytes that the allocator's segments of memory pool
    `pool` (a CUDA graph's) hold on `device`."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == device.index
               and tuple(seg["segment_pool_id"]) == tuple(pool))


class Program:
    """One function at one static key on one device: eager at its first
    call, captured at its second, replayed after (module docstring)."""

    def __init__(self, name: str, key, spec, device: torch.device, fn):
        self.name, self.key, self.spec = name, key, spec
        self.device, self.fn = device, fn
        self.calls = 0          # eager call + capture + replays
        self.graph = None
        self.slots = None       # the input slots, in flatten order
        self.out = None         # the graph's output tree (its pool)
        self.launches = {}      # {counter: launches} of one replay
        self.capture_s = None   # host seconds of the capture
        self.held = 0           # device bytes of its slots and its pool
        self.lock = threading.Lock()

    @property
    def mode(self) -> str:
        """What the next call does: "eager", "capture" or "replay"."""
        if self.graph is not None:
            return "replay"
        return "capture" if self.calls else "eager"

    def __call__(self, inputs, readback: bool = False, clone: bool = True):
        with self.lock:
            mode = self.mode
            if mode == "eager":
                out = _eager(self.fn, self.spec, inputs, self.device,
                             readback)
                self.calls += 1
                return out
            if mode == "capture":
                with span("jxl.program.capture"):
                    self._capture(inputs)
                    if self.held:
                        _trim(self.device, keep=self)
            else:
                self._load(inputs)
            self._replay()
            self.calls += 1
            return _deliver(self.out, readback, clone)

    def _load(self, inputs) -> None:
        with span("jxl.program.load"), torch.no_grad():
            for slot, x in zip(self.slots, inputs):
                if isinstance(x, torch.Tensor) \
                        and x.data_ptr() == slot.data_ptr() \
                        and x.device == slot.device:
                    continue  # the caller handed the slot itself
                slot.copy_(_host(x) if isinstance(x, np.ndarray) else x)

    def _new_slots(self, inputs, device) -> list:
        """The input slots of a capture, on `device`. An input that is
        another program's own output (a sharded builder's phase 1, handed
        on uncloned) is its own slot: the replay reads it where that
        program writes it, and a load copies into it only when a caller
        hands another tensor."""
        own = {id(t) for p in programs(self.device) if p.out is not None
               for t in flatten(p.out)[0]}
        return [x if id(x) in own and x.is_contiguous() else
                torch.empty(x.shape, dtype=_dtype(x), device=device)
                for x in inputs]

    def _capture(self, inputs) -> None:
        self.slots = self._new_slots(inputs, self.device)
        self._load(inputs)
        args, kwargs = unflatten(self.spec, self.slots)
        graph = torch.cuda.CUDAGraph()
        side = _side_stream(self.device)
        with torch.cuda.stream(side):
            # this thread's cuBLAS handle and its workspace for the side
            # stream, made before the capture, which may not make them
            a = torch.ones((1, 8, 8), device=self.device)
            torch.bmm(a, a)
        side.synchronize()
        # the capture begins on the current device's current stream: the
        # program's device (a mesh drives several), whose stream is the
        # side stream (a replay launches on its capture's device itself)
        with _CAPTURE_LOCK, torch.cuda.device(self.device):
            t = time.perf_counter()
            with recording_launches() as launches, torch.inference_mode():
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    out = self.fn(*args, **kwargs)
            self.capture_s = time.perf_counter() - t
        leaves, _ = flatten(out)
        if not all(isinstance(t, torch.Tensor) for t in leaves):
            raise TypeError(f"program {self.name}: outputs must be tensors")
        self.graph, self.out, self.launches = graph, out, launches
        self.held = _pool_bytes(self.device, graph.pool()) + sum(
            t.untyped_storage().nbytes()
            for t, x in zip(self.slots, inputs) if t is not x)

    def _replay(self) -> None:
        with span("jxl.program.replay"):
            self.graph.replay()
            for name, n in self.launches.items():
                launch_counter(name).add(n)


def cached(name: str, key, spec, device: torch.device, fn) -> Program:
    """The program (name, key, spec) of `device` from the cache, made with
    fn when it is not there; the least recently used of the device's
    programs is dropped past CACHE_SIZE."""
    ck = (name, key, spec)
    with _CACHE_LOCK:
        cache = _CACHES.setdefault(device, collections.OrderedDict())
        prog = cache.get(ck)
        if prog is None:
            prog = cache[ck] = Program(name, key, spec, device, fn)
            while len(cache) > CACHE_SIZE:
                cache.popitem(last=False)
        else:
            cache.move_to_end(ck)
    return prog


def held_limit(device: torch.device) -> int:
    """The device bytes that the captured programs of `device` may hold."""
    return torch.cuda.get_device_properties(device).total_memory \
        // HELD_SHARE


def _trim(device: torch.device, keep: Program) -> None:
    """Drop the least recently used programs of `device` that hold memory,
    but `keep`, while the memory they hold together passes held_limit."""
    limit = held_limit(device)
    with _CACHE_LOCK:
        cache = _CACHES.get(device, {})
        held = sum(p.held for p in cache.values())
        for ck, prog in list(cache.items()):
            if held <= limit:
                break
            if prog is not keep and prog.held:
                held -= prog.held
                del cache[ck]


def programs(device) -> list[Program]:
    """The cached programs of `device`, least recently used first."""
    with _CACHE_LOCK:
        return list(_CACHES.get(torch.device(device), {}).values())


def clear(device=None) -> None:
    """Drop the cached programs of `device` (of every device if None)."""
    with _CACHE_LOCK:
        if device is None:
            _CACHES.clear()
        else:
            _CACHES.pop(torch.device(device), None)


def run(name: str, key, fn, *args, device, mark=None, readback=False,
        clone=True, **kwargs):
    """fn(*args, **kwargs) through the program (name, key) of `device`:
    see the module docstring. readback returns the outputs as numpy
    arrays; clone=False returns a replayed program's own output tensors,
    valid until its next call."""
    dev = torch.device(device)
    inputs, spec = flatten((args, kwargs))
    if mark is not None:
        return _eager(fn, spec, inputs, dev, readback, mark=mark)
    if dev.type == "cpu":
        return _eager(fn, spec, inputs, dev, readback)
    if dev.type != "cuda":
        raise ValueError(f"programs: device {dev} (CUDA or the CPU)")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return cached(name, key, spec, dev, fn)(inputs, readback, clone)
