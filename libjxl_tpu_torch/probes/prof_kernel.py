"""S7 on Hopper: the stream-copy floor of the rANS decode, and a profile of
the device-entropy path on a real batch (the port of
scratch/prof_kernel.py, which split the TPU's device entropy decode into
the kernel, its driver's glue and phase 2).

glue launches ops/csrc/ans_probe.cu: ans_decode's data movement (read
each lane's stream, write its tape) with the decode taken out, at
ans_decode's arguments and in its geometry: its CTA table, each lane's
stream through its cp.async ring in shared memory, two halfwords a step;
glue_plain is its twin. ans_decode's cost a step less the floor's is the
decode's own.
profile_entropy times, with CUDA events, the floor, ans_decode at three
step caps (a line through them gives the fixed cost and the cost a step),
the tape's zero-fill and place's pieces. The pieces are torch ops: they
are timed, not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..api.tpu_codec import prepare_batch_entropy
from ..base.device import launch_counter, resolve_device
from ..ops import ans_kernel, kernels
from ..ops.ans_kernel import LaneTensors
from ..ops.build import load as load_kernels
from ..ops.kernels import _check_cuda, _launch, _require, _stream
from .gather import _bits, event_ms

GLUE_LAUNCHES = launch_counter("glue")


def glue(lt: LaneTensors, steps: torch.Tensor):
    """S7, scratch/prof_kernel.py:88 glue (K3's driver loop around a no-op
    kernel): for each lane and step t < min(steps[lane], lt.t_alloc),
    tape[t, lane] = the 32-bit word at halfword lane_off[lane] + 2t (low
    halfword first, reads past the end clamped to the last halfword).
    Returns (tape i32[t_alloc, L], zero past each lane's steps; ok bool[L],
    all set). steps int32 [L], e.g. ans_decode's."""
    dev = lt.flat_hw.device
    if dev.type == "cpu":
        return glue_plain(lt, steps)
    L, alias_words, n_cta = kernels.check_lanes("glue", lt)
    _check_cuda("glue: steps", steps, torch.int32, (L,), dev)
    tape = torch.zeros((lt.t_alloc, L), dtype=torch.int32, device=dev)
    ok = torch.empty(L, dtype=torch.bool, device=dev)
    _launch("glue", load_kernels().jxl_ans_stream_floor(
        lt.flat_hw.data_ptr(), lt.flat_hw.numel(), lt.lane_off.data_ptr(),
        lt.n_chains.data_ptr(), lt.bw.data_ptr(), lt.lane_img.data_ptr(),
        lt.a1.data_ptr(), lt.a2.data_ptr(), lt.nzclu.data_ptr(),
        lt.zdclu.data_ptr(), lt.kz.data_ptr(), alias_words, lt.las, L,
        lt.t_alloc, lt.cta_first.data_ptr(), n_cta, tape.data_ptr(),
        ok.data_ptr(), steps.data_ptr(), _stream(dev), dev.index))
    GLUE_LAUNCHES.add()
    return tape, ok


def glue_plain(lt: LaneTensors, steps: torch.Tensor):
    """glue's plain twin, all steps at once."""
    dev = lt.flat_hw.device
    flat = lt.flat_hw.to(torch.int64) & 0xFFFF
    last = flat.numel() - 1
    t = torch.arange(lt.t_alloc, device=dev)[:, None]
    pos = lt.lane_off[None, :] + 2 * t
    word = flat[pos.clamp(max=last)] | (flat[(pos + 1).clamp(max=last)] << 16)
    tape = torch.where(t < steps.to(torch.int64)[None, :], _bits(word), 0)
    return tape.to(torch.int32), torch.ones(lt.lane_off.numel(),
                                            dtype=torch.bool, device=dev)


def _line(xs, ys) -> tuple[float, float]:
    """Least-squares (slope, intercept) of ys over xs."""
    slope, intercept = np.polyfit(np.asarray(xs, float),
                                  np.asarray(ys, float), 1)
    return float(slope), float(intercept)


PLACE_PIECES = ("cumsum", "searchsorted", "gather", "permutation")
REPS = 3              # passes over place's pieces


def _place_pieces(tape: torch.Tensor, lp: ans_kernel.LanePlan):
    """place's pieces after the transpose, timed with CUDA events image by
    image: ({piece: [ms of each image]}, the least of REPS passes), and
    the qimg they built."""
    dev = tape.device
    g = lp.gy * lp.gx
    q = ans_kernel.chain_queries(g, dev)
    inv = torch.from_numpy(np.ascontiguousarray(lp.inv_order)).to(dev)
    tl_all = ans_kernel.lane_major(tape)
    best = {n: [float("inf")] * lp.B for n in PLACE_PIECES}
    out = torch.empty((lp.B, 3, lp.H, lp.W), dtype=torch.int32, device=dev)

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    for _ in range(REPS):
        marks = [mark()]
        for b in range(lp.B):
            tl = tl_all[b * g:(b + 1) * g]
            cum = ans_kernel.chain_cumsum(tl)
            marks.append(mark())
            starts = ans_kernel.chain_starts(cum, q)
            marks.append(mark())
            coeff = ans_kernel.chain_coeffs(tl, starts)
            marks.append(mark())
            out[b] = ans_kernel.to_raster(coeff, inv[b], lp)
            marks.append(mark())
        torch.cuda.synchronize(dev)
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        for b in range(lp.B):
            for i, n in enumerate(PLACE_PIECES):
                best[n][b] = min(best[n][b], ms[4 * b + i])
    return best, out


def profile_entropy(streams, device) -> dict:
    """Times of the device-entropy path's device stages on one batch, by
    CUDA events (the least of 3 runs after a warm-up), in ms.

    The batch goes through prepare_batch_entropy; ans_decode runs at the
    full t_alloc and capped at 1/8 and 1/64 of the batch's most steps (a
    capped lane is not ok; only the time is read), as does the
    stream-copy floor glue; a least-squares line through each gives its
    ms a step and its fixed ms. glue_plain, the floor's twin, is timed at
    the full t_alloc; the two slopes' difference is the decode's own ns a
    step. Also: the tape's allocation and zero-fill as ans_decode makes
    it, and place's pieces on the first image and summed over the batch
    (the transpose: of the first image's lanes, and of the batch's),
    beside the whole place. Needs a CUDA device."""
    dev = resolve_device(device)
    _require(dev.type == "cuda", f"profile_entropy: device {dev}; the "
             "profile times a card")
    _, _, lp = prepare_batch_entropy(streams)
    lt = lp.to(dev)
    tape, ok, steps = kernels.ans_decode(lt)
    _require(bool(ok.all()), "profile_entropy: ans_decode flagged lanes")
    most = int(steps.max())
    caps = (lp.t_alloc, most // 8, most // 64)
    xs = [min(c, most) for c in caps]
    decode, floor = [], []
    for cap in caps:
        capped = dataclasses.replace(lt, t_alloc=cap)
        decode.append(event_ms(lambda: kernels.ans_decode(capped)))
        floor.append(event_ms(lambda: glue(capped, steps)))
    d_slope, d_icpt = _line(xs, decode)
    f_slope, f_icpt = _line(xs, floor)
    floor_plain = event_ms(lambda: glue_plain(lt, steps), 1)
    zero_fill = event_ms(lambda: torch.zeros((lp.t_alloc, lp.n_lanes),
                                             dtype=torch.int32, device=dev))
    cut = tape[:most]
    placed = ans_kernel.place(cut, lp)
    place_ms = event_ms(lambda: ans_kernel.place(cut, lp))
    g = lp.gy * lp.gx
    transpose = (event_ms(lambda: ans_kernel.lane_major(cut[:, :g])),
                 event_ms(lambda: ans_kernel.lane_major(cut)))
    pieces, built = _place_pieces(cut, lp)
    _require(torch.equal(built, placed),
             "profile_entropy: place's pieces do not rebuild place")
    return {
        "lanes": lp.n_lanes, "ctas": lt.cta_first.numel() - 1,
        "images": lp.B, "t_alloc": lp.t_alloc,
        "steps_max": most, "steps_min": int(steps.min()),
        "steps_sum": int(steps.sum()),
        "caps": list(caps), "step_points": xs,
        "ans_decode_ms": decode, "floor_ms": floor,
        "ans_decode_ns_per_step": d_slope * 1e6,
        "ans_decode_fixed_ms": d_icpt,
        "floor_ns_per_step": f_slope * 1e6, "floor_fixed_ms": f_icpt,
        "floor_plain_ms": floor_plain,
        "decode_ns_per_step": (d_slope - f_slope) * 1e6,
        "tape_zero_fill_ms": zero_fill, "place_ms": place_ms,
        "place_image0_ms": {"transpose": transpose[0],
                            **{n: v[0] for n, v in pieces.items()}},
        "place_batch_ms": {"transpose": transpose[1],
                           **{n: float(sum(v)) for n, v in pieces.items()}},
    }
