"""Device choice, precision policy, kernel launch counters and spans.

Device: every entry point takes a device, "cuda" unless the caller asks
for the CPU, and resolves it here. Asking for CUDA without a card raises;
nothing falls back to the CPU. (api/codestream's decode entries also take
device=None, the host decode of the copied host layers.)

Precision: fp32 throughout, with TF32 off for matmuls and cuDNN. This is
the counterpart of the JAX package's `Precision.HIGHEST`
(libjxl_tpu/ops/pipeline.py:68-78, docs/architecture.md "Precision
policy"): the conformance error bounds do not survive TF32's 10-bit
mantissa.

Launch counters: each hand-written kernel's wrapper owns one counter and
adds one where it launches its kernel, and nowhere else, so a run can
show that its main path went through the kernels. While a thread
captures a CUDA graph (ops/programs.py) its wrappers' launches are
recorded instead of counted (recording_launches), and each replay of
the graph adds what its capture recorded. One counter counts host work
instead: "ac_native_sub", a chroma-subsampled frame's AC decoded by the
native whole-image call (vardct/subsampled.decode_ac_bulk_native_sub),
so a run can show that a transcoded JPEG took that route.

Spans: span(name) marks a stretch of host work as a torch.profiler range
(record_function) while a torch profiler records, and is one shared null
context otherwise, so tracing is on exactly when a profiler is: the
benchmark's traced run or an operator's own torch.profiler. The ranges
land in the profiler's timeline beside the kernels and copies, on the
device trace's clock. Spans nest on the calling thread: the span that
caused a span is the one around it, and each entry call's root span
(jxl.decode, jxl.decode_batch_entropy, jxl.decode_batch,
jxl.decode_batch_sharded, jxl.decode_pipelined) marks one request. The
port's spans, every name starting with "jxl.":

- jxl.headers: the codestream, frame header and TOC reads;
- jxl.frame.init: a VarDCT frame's decoder state made (vardct/frame.py);
- jxl.frame.dc, jxl.frame.ac_global, jxl.frame.ac: a frame's DC (global
  and groups), AC global and AC group sections (api/frame.py);
- jxl.entropy.plan: the device-entropy lane plan (api/tpu_codec.py);
- jxl.stage: a batch's or a frame's render inputs made on the host
  (an XYB frame's stage_image, a YCbCr frame's _stage_subsampled);
- jxl.program.eager, .capture, .load, .replay, .readback: the program
  layer (ops/programs.py).

No span is inside a captured program body, and none synchronizes.
"""

from __future__ import annotations

import contextlib
import functools
import subprocess
import threading

import torch


def apply_precision_policy() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """`device` as a torch.device, after applying the precision policy.

    Raises for a CUDA device when no card is present, and for any device
    type other than cpu and cuda."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    apply_precision_policy()
    return dev


_RECORDING = threading.local()


class LaunchCounter:
    """Number of launches of one kernel (thread-safe)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        record = getattr(_RECORDING, "launches", None)
        if record is not None:
            record[self.name] = record.get(self.name, 0) + n
            return
        with self._lock:
            self.count += n

    def reset(self) -> None:
        with self._lock:
            self.count = 0


_COUNTERS: dict[str, LaunchCounter] = {}


def launch_counter(name: str) -> LaunchCounter:
    """The counter registered under `name` (created on first use)."""
    return _COUNTERS.setdefault(name, LaunchCounter(name))


# counters of host work done in native C, once a frame, which
# launch_counts() reports beside the kernels' launches
HOST_WORK_COUNTERS = ("ac_native_sub", "ac_global_native")


def launch_counts() -> dict[str, int]:
    return {name: c.count for name, c in _COUNTERS.items()}


def kernel_launch_counts() -> dict[str, int]:
    """launch_counts() of the kernels alone: no HOST_WORK_COUNTERS."""
    return {name: n for name, n in launch_counts().items()
            if name not in HOST_WORK_COUNTERS}


def reset_launch_counts() -> None:
    for c in _COUNTERS.values():
        c.reset()


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's launches go into the yielded dict
    ({counter name: launches}) and not into the counters: a graph capture
    queues its kernels without running them."""
    if getattr(_RECORDING, "launches", None) is not None:
        raise RuntimeError("recording_launches: already recording")
    _RECORDING.launches = record = {}
    try:
        yield record
    finally:
        _RECORDING.launches = None


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks its block as the profiler range `name` while a
    torch profiler records, and does nothing otherwise (module
    docstring)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorator: each call of the function inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them: the
    label every device number is kept with."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def add_device_args(parser, what: str) -> None:
    """A tool's --device {cuda,cpu} (default cuda) and --host flags, for
    `what` (e.g. "a .jxl input's decode"); cli_device reads them."""
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help=f"torch device of {what}: cuda (the default; "
                             "raises without a card) or cpu (the kernels' "
                             "plain twins)")
    parser.add_argument("--host", action="store_true",
                        help=f"run {what} on the host (no device stage)")


def cli_device(args):
    """The device the parsed --device / --host flags ask for: None (the
    host route) under --host."""
    return None if args.host else args.device
