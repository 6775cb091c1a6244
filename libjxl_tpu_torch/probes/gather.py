"""The TPU gather probes S1-S6 on Hopper: each a hand-written CUDA kernel
(ops/csrc/gather_probe.cu) beside its plain torch twin.

The TPU probes (scratch/gather_bench.py, gather_bench2.py,
gather_bench3.py, gather_forms.py) timed one form each of a per-lane
dependent lookup, the step of a rANS decode, and chose the TPU kernel
K3's design. Here each form runs 1024 lanes as 32 CTAs of 32 threads,
one warp an SM, and is timed by the probes' own method: the marginal
cost t(5 iters) - t(iters) over 4 iters, so a lane-step compares with a
step of ans_decode.

A wrapper given CPU tensors returns its plain twin (a loop of torch ops
over the same tensors). Given CUDA tensors it launches its kernel on the
current stream, or raises; no path falls back. Each wrapper adds one to
its launch counter (named after its scratch function) per launch. u32
states (S1-S3) travel as their int32 bit patterns; the twins hold them in
int64 masked to 32 bits, since torch has no u32 multiply.

    python -m libjxl_tpu_torch.probes.gather

checks every form against its twin on the card and prints one line a
form (kernel and twin ns per lane-step, lookups/s, the card).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable

import numpy as np
import torch

from ..base.device import card_line, launch_counter, resolve_device
from ..ops.build import load as load_kernels
from ..ops.kernels import _check_cuda, _launch, _require, _stream

SHAPE = (8, 128)      # the TPU probes' lane grid
LANES = 1024
GOLDEN = 2654435761   # the probes' multiplicative hash
WL_CALLS = 560        # scratch/gather_forms.py wl_pallas's loop
WL_SHAPE = (120, 8, 128)
CHECK_ITERS = 64      # steps of a kernel-against-twin check
PLAIN_ITERS = 40      # the twins' count: a twin launches torch ops a step
_M32 = 0xFFFFFFFF
_I64 = torch.int64

BENCH_PALLAS_GATHER_LAUNCHES = launch_counter("bench_pallas_gather")
BENCH_PALLAS_2D_GATHER_LAUNCHES = launch_counter("bench_pallas_2d_gather")
BENCH_PALLAS_ONEHOT_WINDOW_LAUNCHES = launch_counter(
    "bench_pallas_onehot_window")
RUN_FORM_LAUNCHES = launch_counter("make_runner")
PROBE_LAUNCHES = launch_counter("probe")
WL_PALLAS_LAUNCHES = launch_counter("wl_pallas")
# each probe's launch counter and the TPU kernel it replaces
PROBES = {
    "S1": (BENCH_PALLAS_GATHER_LAUNCHES, "scratch/gather_bench.py:61"),
    "S2": (BENCH_PALLAS_2D_GATHER_LAUNCHES, "scratch/gather_bench.py:95"),
    "S3": (BENCH_PALLAS_ONEHOT_WINDOW_LAUNCHES,
           "scratch/gather_bench.py:132"),
    "S4": (RUN_FORM_LAUNCHES, "scratch/gather_bench2.py:25"),
    "S5": (PROBE_LAUNCHES, "scratch/gather_bench3.py:22"),
    "S6": (WL_PALLAS_LAUNCHES, "scratch/gather_forms.py:111"),
}

# scratch/gather_bench2.py main()'s bodies
BODIES = ("kA", "kA2", "kB", "kC", "kD", "kE", "kF")
# scratch/gather_bench3.py:66-79: label, table (= index) shape, axis,
# idx_mod, iters
PROBE_CASES = (
    ("rowgather (1024,256) ax1", (1024, 256), 1, 256, 500),
    ("rowgather (1024,8) ax1", (1024, 8), 1, 8, 2000),
    ("rowgather (128,256) ax1", (128, 256), 1, 256, 1000),
    ("widegather (8,1024) ax1", (8, 1024), 1, 1024, 1000),
    ("deep axis0 (16,128)", (16, 128), 0, 16, 1000),
    ("deep axis0 (32,128)", (32, 128), 0, 32, 1000),
    ("axis0 (8,256)", (8, 256), 0, 8, 1000),
)
_MEMORY = {"gmem": 0, "smem": 1}
_WINDOW = {"reg": 0, "local": 1, "smem": 2}


def _u32_hash(n: int, mod: int) -> np.ndarray:
    """arange(n) * GOLDEN % mod in u32, the probes' table construction."""
    return (np.arange(n, dtype=np.uint32) * np.uint32(GOLDEN)) \
        % np.uint32(mod)


def probe_inputs(name: str, seed: int | None = None, **params) -> dict:
    """The numpy tables and state of one probe, which both the JAX body and
    the port consume, keyed by the wrapper's argument names.

    Tables are the scratch constructions exactly. The state is the
    scratch's (arange; zeros for wl_pallas) when seed is None, otherwise
    random words from `seed`. name and params: bench_pallas_gather
    (table_size), bench_pallas_2d_gather (table_size),
    bench_pallas_onehot_window (win), make_runner (body), probe (case, an
    index of PROBE_CASES), wl_pallas."""
    rng = np.random.default_rng(seed)

    def u32_state():
        if seed is None:
            return np.arange(LANES, dtype=np.uint32).reshape(SHAPE)
        return rng.integers(0, 1 << 32, SHAPE, dtype=np.uint64).astype(
            np.uint32)

    def i32(shape, base):
        if seed is None:
            return base
        return rng.integers(-2 ** 31, 2 ** 31, shape).astype(np.int32)

    if name == "bench_pallas_gather":
        ts = params["table_size"]
        return {"table": _u32_hash(ts, ts), "state": u32_state()}
    if name == "bench_pallas_2d_gather":
        ts = params["table_size"]
        return {"table": _u32_hash(ts, ts).reshape(ts // 128, 128),
                "state": u32_state()}
    if name == "bench_pallas_onehot_window":
        win = params["win"]
        return {"window": _u32_hash(win * LANES, 997).reshape(win, *SHAPE),
                "state": u32_state()}
    if name == "make_runner":
        body = params["body"]
        _require(body in BODIES, f"make_runner: body {body!r}")
        tbl_a = (np.arange(64 * 128, dtype=np.int32) % 1000).reshape(64, 128)
        tbl_b = (np.arange(8 * 128, dtype=np.int32) % 1000).reshape(SHAPE)
        state = i32(SHAPE, np.arange(LANES, dtype=np.int32).reshape(SHAPE))
        tables = {"kA": {"tbl": tbl_a}, "kA2": {"tbl": tbl_a}, "kD": {},
                  "kF": {"tbl": tbl_b, "win": tbl_b}}.get(body,
                                                          {"tbl": tbl_b})
        return {**tables, "state": state}
    if name == "probe":
        _, shape, _, mod, _ = PROBE_CASES[params["case"]]
        n = int(np.prod(shape))
        return {"table": (np.arange(n) % 997).reshape(shape).astype(np.int32),
                "state": i32(shape, (np.arange(n) % mod).reshape(shape)
                             .astype(np.int32))}
    if name == "wl_pallas":
        return {"a": i32(WL_SHAPE, np.zeros(WL_SHAPE, np.int32))}
    raise ValueError(f"probe_inputs: unknown probe {name!r}")


def as_tensors(arrays: dict, device) -> dict:
    """probe_inputs' arrays as contiguous tensors on `device` (u32 as its
    int32 bit pattern)."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.view(np.int32) if v.dtype == np.uint32 else v)).to(device)
        for k, v in arrays.items()}


def _u64(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns as their u32 values, in int64."""
    return t.to(_I64) & _M32


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 values cut to their low 32 bits, as signed values."""
    return ((x + 2 ** 31) & _M32) - 2 ** 31


def _bits(x: torch.Tensor) -> torch.Tensor:
    return _wrap(x).to(torch.int32)


def _cuda_device(name: str, t: torch.Tensor) -> torch.device:
    _require(t.device.type == "cuda", f"{name}: device {t.device}")
    return t.device


def _lane_state(name: str, state: torch.Tensor) -> torch.device:
    dev = _cuda_device(name, state)
    _check_cuda(f"{name}: state", state, torch.int32, SHAPE, dev)
    return dev


def _iters(name: str, iters: int) -> int:
    _require(0 <= iters < 2 ** 31, f"{name}: iters {iters}")
    return int(iters)


def _choice(name: str, table: dict, variant: str) -> int:
    _require(variant in table, f"{name}: variant {variant!r}, not one of "
             f"{sorted(table)}")
    return table[variant]


# S1, S2 ------------------------------------------------------------------

def _chain(name, counter, table, state, iters, gathers, variant, rowcol):
    dev = _lane_state(name, state)
    T = table.numel()
    _require((T, gathers, rowcol) in ((512, 1, 0), (8192, 3, 0),
                                      (8192, 1, 1)),
             f"{name}: table of {T} words with {gathers} gathers is not a "
             "compiled form")
    _check_cuda(f"{name}: table", table, torch.int32, table.shape, dev)
    out = torch.empty_like(state)
    _launch(name, load_kernels().jxl_probe_chain(
        T, gathers, _choice(name, _MEMORY, variant), rowcol,
        table.data_ptr(), state.data_ptr(), _iters(name, iters),
        out.data_ptr(), _stream(dev), dev.index))
    counter.add()
    return out


def bench_pallas_gather(table, state, iters, gathers, variant="gmem"):
    """S1, scratch/gather_bench.py:61 bench_pallas_gather: per lane,
    `gathers` chained lookups s += table[(s >> 4) % T], then s = s * 5 + 7,
    `iters` times (u32). table int32 [T] (T 512 with 1 gather or 8192 with
    3 on CUDA), state int32 [8, 128]; variant "gmem" or "smem" places the
    table. Returns the final state."""
    if state.device.type == "cpu":
        return bench_pallas_gather_plain(table, state, iters, gathers)
    return _chain("bench_pallas_gather", BENCH_PALLAS_GATHER_LAUNCHES, table,
                  state, iters, gathers, variant, 0)


def bench_pallas_gather_plain(table, state, iters, gathers):
    tbl = _u64(table)
    s = _u64(state)
    for _ in range(iters):
        for _ in range(gathers):
            s = (s + tbl[(s >> 4) % tbl.numel()]) & _M32
        s = (s * 5 + 7) & _M32
    return _bits(s)


def bench_pallas_2d_gather(table, state, iters, variant="gmem"):
    """S2, scratch/gather_bench.py:95 bench_pallas_2d_gather: s = (s +
    table[r, c]) * 5 + 7 with idx = (s >> 4) % T split into r = idx // 128,
    c = idx % 128 (u32). table int32 [64, 128] on CUDA."""
    if state.device.type == "cpu":
        return bench_pallas_2d_gather_plain(table, state, iters)
    _require(table.dim() == 2 and table.shape[1] == 128,
             f"bench_pallas_2d_gather: table shape {tuple(table.shape)}")
    return _chain("bench_pallas_2d_gather", BENCH_PALLAS_2D_GATHER_LAUNCHES,
                  table, state, iters, 1, variant, 1)


def bench_pallas_2d_gather_plain(table, state, iters):
    tbl = _u64(table)
    s = _u64(state)
    for _ in range(iters):
        idx = (s >> 4) % tbl.numel()
        s = ((s + tbl[idx // 128, idx % 128]) * 5 + 7) & _M32
    return _bits(s)


# S3 and S4's windows -----------------------------------------------------

def _window(name, counter, win, state, iters, depth, rule, variant):
    dev = _lane_state(name, state)
    _require(win.dim() >= 2 and win.shape[0] == depth,
             f"{name}: window shape {tuple(win.shape)}")
    _check_cuda(f"{name}: window", win, torch.int32, win.shape, dev)
    cols = win[0].numel()   # lane l's window is column l % cols
    _require(cols in (128, LANES), f"{name}: {cols} window columns")
    out = torch.empty_like(state)
    _launch(name, load_kernels().jxl_probe_window(
        depth, rule, _choice(name, _WINDOW, variant), win.data_ptr(), cols,
        cols - 1, state.data_ptr(), _iters(name, iters), out.data_ptr(),
        _stream(dev), dev.index))
    counter.add()
    return out


def bench_pallas_onehot_window(window, state, iters, variant="reg"):
    """S3, scratch/gather_bench.py:132 bench_pallas_onehot_window: each
    lane selects w[(s >> 4) % 64, lane] from its private 64-word window,
    then s = (s + sel) * 5 + 7 (u32). window int32 [64, 8, 128]; variant
    "reg" (registers, unrolled select: the TPU's one-hot form), "local"
    (a local array indexed directly) or "smem" (a shared slot a thread)."""
    if state.device.type == "cpu":
        return bench_pallas_onehot_window_plain(window, state, iters)
    return _window("bench_pallas_onehot_window",
                   BENCH_PALLAS_ONEHOT_WINDOW_LAUNCHES, window, state, iters,
                   64, 0, variant)


def bench_pallas_onehot_window_plain(window, state, iters):
    w = _u64(window)
    s = _u64(state)
    for _ in range(iters):
        sel = w.gather(0, ((s >> 4) % w.shape[0])[None])[0]
        s = ((s + sel) * 5 + 7) & _M32
    return _bits(s)


# S4 ----------------------------------------------------------------------

def run_form(body, state, iters, variant, tbl=None, win=None):
    """S4, scratch/gather_bench2.py:25 make_runner with one of its bodies
    (main(), :62-180), i32 state [8, 128], wrapping:

    kA, kA2  s += tbl[(s + i) & 63, col] (tbl [64, 128]: the lane's column)
    kE       s += tbl[(s + i) & 7, col]  (tbl [8, 128])
    kB       s += tbl[row, (s + i) & 127] (tbl [8, 128])
    kC       s += tbl.flat[(s + i) & 1023]
    kD       16 x (x = (x * 5 + 7) ^ (x >> 3); x += x << 2), no table
    kF       two 1024-word lookups, a column-window lookup in win and 20
             ALU rounds

    variant: "reg", "local" or "smem" for the windows (kA, kA2, kE);
    "smem" for kB; "smem" or "gmem" for kC and kF; "alu" for kD."""
    if state.device.type == "cpu":
        return run_form_plain(body, state, iters, tbl, win)
    name = f"make_runner {body}"
    if body in ("kA", "kA2", "kE"):
        _require(tbl is not None, f"{name}: needs tbl")
        return _window(name, RUN_FORM_LAUNCHES, tbl, state, iters,
                       8 if body == "kE" else 64, 1, variant)
    dev = _lane_state(name, state)
    kind = {"kB": 0, "kC": 1, "kD": 2, "kF": 3}.get(body)
    _require(kind is not None, f"make_runner: body {body!r}")
    variants = {"kB": ("smem",), "kC": ("smem", "gmem"), "kD": ("alu",),
                "kF": ("smem", "gmem")}[body]
    _require(variant in variants, f"{name}: variant {variant!r}, not one "
             f"of {variants}")
    needs = {"kD": (), "kF": (("tbl", tbl), ("win", win))}.get(
        body, (("tbl", tbl),))
    for arg, t in needs:
        _require(t is not None, f"{name}: needs {arg}")
        _check_cuda(f"{name}: {arg}", t, torch.int32, SHAPE, dev)
    out = torch.empty_like(state)
    _launch(name, load_kernels().jxl_probe_table(
        kind, int(variant == "smem"), None if tbl is None else tbl.data_ptr(),
        None if win is None else win.data_ptr(), state.data_ptr(),
        _iters(name, iters), out.data_ptr(), _stream(dev), dev.index))
    RUN_FORM_LAUNCHES.add()
    return out


def run_form_plain(body, state, iters, tbl=None, win=None):
    s = state.to(_I64)
    t = None if tbl is None else tbl.to(_I64)
    w = None if win is None else win.to(_I64)

    def alu(x, rounds, add_shift):
        for _ in range(rounds):
            x = _wrap((x * 5 + 7) ^ (x >> 3))
            if add_shift:
                x = _wrap(x + (x << 2))
        return x

    for i in range(iters):
        if body in ("kA", "kA2", "kE"):
            s = _wrap(s + t.gather(0, (s + i) & (t.shape[0] - 1)))
        elif body == "kB":
            s = _wrap(s + t.gather(1, (s + i) & 127))
        elif body == "kC":
            s = _wrap(s + t.reshape(-1)[(s + i) & 1023])
        elif body == "kD":
            s = alu(s, 16, True)
        elif body == "kF":
            x = _wrap(s + t.reshape(-1)[(s + i) & 1023])
            x = x ^ t.reshape(-1)[(x * 3 + 1) & 1023]
            x = _wrap(x + w.gather(0, x & 7))
            s = alu(x, 20, False)
        else:
            raise ValueError(f"make_runner: body {body!r}")
    return s.to(torch.int32)


# S5 ----------------------------------------------------------------------

def _group(n_other: int, n_along: int) -> int:
    """Rows (axis 1) or columns (axis 0) a CTA holds: about 256 threads,
    a divisor of the count of rows or columns."""
    g = max(1, 256 // n_along)
    while n_other % g:
        g //= 2
    return g


def probe(table, state, iters, axis, idx_mod, variant="smem"):
    """S5, scratch/gather_bench3.py:22 probe: s += take_along_axis(table,
    (s + i) % idx_mod, axis) (i32, floor-mod), one thread per element of
    the state. table and state int32 [H, W] of one shape; variant "smem"
    holds the CTA's rows (axis 1) or columns (axis 0) in shared memory,
    "gmem" reads them from device memory."""
    if state.device.type == "cpu":
        return probe_plain(table, state, iters, axis, idx_mod)
    dev = _cuda_device("probe", state)
    _require(state.dim() == 2 and axis in (0, 1) and idx_mod > 0,
             f"probe: state shape {tuple(state.shape)}, axis {axis}, "
             f"idx_mod {idx_mod}")
    H, W = state.shape
    _require(idx_mod <= (W if axis == 1 else H),
             f"probe: idx_mod {idx_mod} exceeds the axis")
    _check_cuda("probe: state", state, torch.int32, (H, W), dev)
    _check_cuda("probe: table", table, torch.int32, (H, W), dev)
    group = _group(H, W) if axis == 1 else _group(W, H)
    _require(group * (W if axis == 1 else H) <= 1024,
             f"probe: a {'row' if axis == 1 else 'column'} exceeds a CTA")
    out = torch.empty_like(state)
    _launch("probe", load_kernels().jxl_probe_take_along(
        _choice("probe", _MEMORY, variant), table.data_ptr(),
        state.data_ptr(), H, W, axis, idx_mod, group, _iters("probe", iters),
        out.data_ptr(), _stream(dev), dev.index))
    PROBE_LAUNCHES.add()
    return out


def probe_plain(table, state, iters, axis, idx_mod):
    t = table.to(_I64)
    s = state.to(_I64)
    for i in range(iters):
        s = _wrap(s + t.gather(axis, _wrap(s + i) % idx_mod))
    return s.to(torch.int32)


# S6 ----------------------------------------------------------------------

def _noop_launches(a, bufs, calls, dev):
    """`calls` no-op launches, each reading the previous one's output. The
    loop makes one C call a launch: what a launch costs is the measure."""
    noop, stream = load_kernels().jxl_probe_noop, _stream(dev)
    n = a[0].numel()
    ptrs = [a.data_ptr()] + [bufs[k % 2].data_ptr() for k in range(calls)]
    for src, dst in zip(ptrs, ptrs[1:]):
        _launch("wl_pallas", noop(src, dst, n, stream, dev.index))
    return bufs[(calls - 1) % 2]


def _wl_check(a: torch.Tensor, calls: int) -> torch.device:
    dev = _cuda_device("wl_pallas", a)
    _require(a.dim() >= 2, f"wl_pallas: shape {tuple(a.shape)}")
    _check_cuda("wl_pallas: a", a, torch.int32, a.shape, dev)
    _require(calls > 0, f"wl_pallas: calls {calls}")
    return dev


def wl_pallas(a, calls=WL_CALLS):
    """S6, scratch/gather_forms.py:111 wl_pallas: `calls` back-to-back
    launches of a no-op kernel (o[0] = a[0]), each on the previous one's
    output: the cost of one more launch. Only row 0 of the result is
    defined; it equals a[0]. a int32 [N, ...] on CUDA."""
    if a.device.type == "cpu":
        return wl_pallas_plain(a, calls)
    dev = _wl_check(a, calls)
    out = _noop_launches(a, (torch.empty_like(a), torch.empty_like(a)),
                         calls, dev)
    WL_PALLAS_LAUNCHES.add(calls)
    return out


class WlPallasGraph:
    """wl_pallas's `calls` launches captured once in a CUDA graph; each
    call replays them and returns the output buffer (row 0 = a[0])."""

    def __init__(self, a, calls=WL_CALLS):
        dev = _wl_check(a, calls)
        self.a, self.calls = a, calls
        self.bufs = (torch.empty_like(a), torch.empty_like(a))
        self.graph = torch.cuda.CUDAGraph()
        _noop_launches(a, self.bufs, 1, dev)  # load the module before capture
        torch.cuda.synchronize(dev)
        with torch.cuda.graph(self.graph):
            self.out = _noop_launches(a, self.bufs, calls, dev)
        # the capture's launches did not run; this one did
        WL_PALLAS_LAUNCHES.add()

    def __call__(self):
        self.graph.replay()
        WL_PALLAS_LAUNCHES.add(self.calls)
        return self.out


def wl_pallas_plain(a, calls=WL_CALLS):
    for _ in range(calls):
        o = torch.empty_like(a)
        o[0] = a[0]
        a = o
    return a


# the forms and their timing ------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Form:
    """One timed form: a wrapper at fixed arguments and variant."""

    probe: str            # S1 .. S5
    name: str
    fn: Callable          # the kernel's wrapper
    plain: Callable       # its plain twin
    inputs: tuple         # probe_inputs' (name, params)
    args: dict            # the computation's own arguments
    variant: str
    iters: int            # the TPU probe's count
    lookups: int          # table or window lookups a lane-step

    def tensors(self, device, seed=None) -> dict:
        name, params = self.inputs
        return as_tensors(probe_inputs(name, seed, **params), device)

    def __call__(self, tensors, iters, plain=False):
        if plain:
            return self.plain(**tensors, iters=iters, **self.args)
        return self.fn(**tensors, iters=iters, **self.args,
                       variant=self.variant)

    @property
    def lanes(self) -> int:
        if self.probe != "S5":
            return LANES
        return int(np.prod(PROBE_CASES[self.inputs[1]["case"]][1]))


def _forms() -> tuple:
    out = []
    for ts, g in ((512, 1), (8192, 3)):
        for v in _MEMORY:
            out.append(Form("S1", f"S1 take tbl={ts} g={g} {v}",
                            bench_pallas_gather, bench_pallas_gather_plain,
                            ("bench_pallas_gather", {"table_size": ts}),
                            {"gathers": g}, v, 2000, g))
    for v in _MEMORY:
        out.append(Form("S2", f"S2 2d-idx tbl=8192 {v}",
                        bench_pallas_2d_gather, bench_pallas_2d_gather_plain,
                        ("bench_pallas_2d_gather", {"table_size": 8192}),
                        {}, v, 2000, 1))
    for v in _WINDOW:
        out.append(Form("S3", f"S3 onehot win=64 {v}",
                        bench_pallas_onehot_window,
                        bench_pallas_onehot_window_plain,
                        ("bench_pallas_onehot_window", {"win": 64}), {}, v,
                        2000, 1))
    # kA2 computes kA's result (its tiled index only fed the TPU); the
    # tests hold both JAX bodies to the port, the card times kA
    s4 = (("kA", tuple(_WINDOW), 1), ("kB", ("smem",), 1),
          ("kC", ("smem", "gmem"), 1), ("kD", ("alu",), 0),
          ("kE", tuple(_WINDOW), 1), ("kF", ("smem", "gmem"), 3))
    for body, variants, lookups in s4:
        for v in variants:
            out.append(Form("S4", f"S4 {body} {v}", run_form, run_form_plain,
                            ("make_runner", {"body": body}), {"body": body},
                            v, 3000, lookups))
    for case, (label, _, axis, mod, iters) in enumerate(PROBE_CASES):
        for v in _MEMORY:
            out.append(Form("S5", f"S5 {label} {v}", probe, probe_plain,
                            ("probe", {"case": case}),
                            {"axis": axis, "idx_mod": mod}, v, iters, 1))
    return tuple(out)


FORMS = _forms()


# Integer operations of one lane-step of each form, counted from its
# body: S1 a gather is (s >> 4) % T and an add, then * 5 + 7; S2 adds a
# row/column split; S3 selects from the window and mixes; S4 kA/kB/kC/kE
# index and add, kD 16 rounds of 6 operations, kF three lookups and 20
# rounds of 4; S5 index, mod and add.
OPS_PER_STEP = {"S1": {1: 5, 3: 11}, "S2": 7, "S3": 5,
                "S4": {"kA": 3, "kB": 3, "kC": 3, "kD": 96, "kE": 3,
                       "kF": 89},
                "S5": 3}


def form_work(form: Form, iters: int) -> tuple[int, int]:
    """(bytes, operations) that `iters` steps of `form` need: each input
    read once and the state written once; the operations of OPS_PER_STEP
    for every lane."""
    name, params = form.inputs
    arrays = probe_inputs(name, **params)
    nbytes = sum(a.nbytes for a in arrays.values()) \
        + arrays["state"].nbytes
    ops = OPS_PER_STEP[form.probe]
    if form.probe == "S1":
        ops = ops[form.args["gathers"]]
    elif form.probe == "S4":
        ops = ops[form.args["body"]]
    return nbytes, form.lanes * iters * ops


def _once_ms(fn) -> float:
    """Device milliseconds of one fn() (CUDA events around it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def event_ms(fn, reps: int = 3) -> float:
    """Least device milliseconds of fn() over `reps` runs after one
    warm-up."""
    fn()
    torch.cuda.synchronize()
    return min(_once_ms(fn) for _ in range(reps))


def marginal_ns(fn, iters: int, reps: int = 5) -> float:
    """Ns a step of fn(n): the TPU probes' marginal cost,
    (t(5 iters) - t(iters)) / (4 iters). A warm-up at 5 iters first, then
    the two counts in turns, the least of each: a card whose clock has not
    come up yet would inflate whichever count ran first."""
    fn(5 * iters)
    torch.cuda.synchronize()
    t1 = t5 = float("inf")
    for _ in range(reps):
        t1 = min(t1, _once_ms(lambda: fn(iters)))
        t5 = min(t5, _once_ms(lambda: fn(5 * iters)))
    return (t5 - t1) * 1e6 / (4 * iters)


def check_form(form: Form, device) -> int:
    """Max abs difference of the kernel's state from its twin's after
    CHECK_ITERS steps on `device`, on the scratch state and a seeded one."""
    err = 0
    for seed in (None, 0):
        t = form.tensors(device, seed)
        got = form(t, CHECK_ITERS)
        ref = form(t, CHECK_ITERS, plain=True)
        torch.cuda.synchronize()
        err = max(err, int((got.to(_I64) - ref.to(_I64)).abs().max()))
    return err


def time_form(form: Form, device, plain_cache: dict) -> dict:
    """The kernel's marginal ns a lane-step at the TPU probe's count, the
    twin's at PLAIN_ITERS, and both at 5 * PLAIN_ITERS in ms; a twin that
    several variants share is timed once, through `plain_cache`."""
    t = form.tensors(device)
    ns = marginal_ns(lambda n: form(t, n), form.iters)
    ms = event_ms(lambda: form(t, 5 * PLAIN_ITERS))
    key = (form.plain, repr(form.inputs), repr(form.args))
    if key not in plain_cache:
        plain_cache[key] = (
            marginal_ns(lambda n: form(t, n, plain=True), PLAIN_ITERS, 1),
            event_ms(lambda: form(t, 5 * PLAIN_ITERS, plain=True), 1))
    p_ns, p_ms = plain_cache[key]
    lookups = form.lanes * form.lookups
    return {"name": form.name, "iters": form.iters, "ns_per_step": ns,
            "lookups_per_s": lookups / ns * 1e9, "plain_iters": PLAIN_ITERS,
            "plain_ns_per_step": p_ns, "ms": ms, "plain_ms": p_ms,
            "ms_iters": 5 * PLAIN_ITERS}


def check_wl_pallas(device) -> int:
    """Max abs difference of row 0 after WL_CALLS launches, eager and
    graph-replayed, from the twin's, on the scratch and a seeded input."""
    err = 0
    for seed in (None, 0):
        a = as_tensors(probe_inputs("wl_pallas", seed), device)["a"]
        ref = wl_pallas_plain(a)[0]
        for got in (wl_pallas(a)[0], WlPallasGraph(a)()[0]):
            torch.cuda.synchronize()
            err = max(err, int((got.to(_I64) - ref.to(_I64)).abs().max()))
    return err


def time_wl_pallas(device) -> dict:
    """Device µs a launch of the no-op kernel: WL_CALLS eager launches,
    the same captured once in a CUDA graph and replayed, the twin's
    WL_CALLS iterations, and WL_CALLS calls of Tensor.copy_ of row 0, the
    PyTorch call that computes what a launch does."""
    a = as_tensors(probe_inputs("wl_pallas"), device)["a"]
    graph = WlPallasGraph(a)
    eager = event_ms(lambda: wl_pallas(a))
    replay = event_ms(graph)
    plain = event_ms(lambda: wl_pallas_plain(a))
    # the one PyTorch call that computes a launch's function: row 0's copy
    row = torch.empty_like(a[0])
    library = event_ms(lambda: [row.copy_(a[0]) for _ in range(WL_CALLS)])
    return {"name": "S6 no-op x560", "calls": WL_CALLS, "ms": eager,
            "graph_ms": replay, "plain_ms": plain, "library_ms": library,
            # each launch reads and writes row 0
            "bytes": 2 * WL_CALLS * a[0].numel() * a.element_size(),
            "us_per_launch": eager * 1e3 / WL_CALLS,
            "graph_us_per_launch": replay * 1e3 / WL_CALLS,
            "plain_us_per_call": plain * 1e3 / WL_CALLS,
            "library_us_per_call": library * 1e3 / WL_CALLS}


def check_probes(device) -> dict[str, int]:
    """Max abs difference of every kernel from its twin, per probe (S1-S6),
    on `device`: check_form for each form, check_wl_pallas for S6."""
    errs = {p: 0 for p in PROBES}
    for form in FORMS:
        errs[form.probe] = max(errs[form.probe], check_form(form, device))
    errs["S6"] = check_wl_pallas(device)
    return errs


def run_probes(device) -> tuple[list[dict], dict]:
    """Every form timed by time_form, and S6 by time_wl_pallas."""
    cache = {}
    forms = [time_form(f, device, cache) for f in FORMS]
    return forms, time_wl_pallas(device)


def form_line(rec: dict, card: str) -> str:
    return (f"{rec['name']}: kernel {rec['ns_per_step']:.3f} ns/lane-step "
            f"at {rec['iters']} iters ({rec['lookups_per_s'] / 1e9:.3f} G "
            f"lookups/s), twin {rec['plain_ns_per_step']:.1f} ns/lane-step "
            f"at {rec['plain_iters']} iters; {card}")


def wl_line(rec: dict, card: str) -> str:
    return (f"{rec['name']}: {rec['us_per_launch']:.3f} us a launch eager, "
            f"{rec['graph_us_per_launch']:.3f} us in a CUDA graph, twin "
            f"{rec['plain_us_per_call']:.3f} us a call; {card}")


def main() -> int:
    if not torch.cuda.is_available():
        print("probes.gather: CUDA is not available; the probes time a "
              "card", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    card = card_line()
    bad = [p for p, err in check_probes(dev).items() if err]
    forms, wl = run_probes(dev)
    for rec in forms:
        print(form_line(rec, card), flush=True)
    print(wl_line(wl, card), flush=True)
    if bad:
        print(f"probes.gather: differ from their twins: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
