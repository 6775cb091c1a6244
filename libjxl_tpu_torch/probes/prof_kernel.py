"""S7 on Hopper: the stream-copy floor of the rANS decode (the port of
scratch/prof_kernel.py's glue, which split the TPU's device entropy decode
into the kernel, the host loop around it (glue) and phase 2).

glue launches ops/csrc/ans_probe.cu: ans_decode's data movement (read
each lane's stream, write its tape) with the decode taken out, at
ans_decode's arguments and in its geometry: its CTA table, each lane's
stream through its cp.async ring in shared memory, two halfwords a step;
glue_plain is its twin. ans_decode's cost a step less the floor's is the
decode's own.
"""

from __future__ import annotations

import torch

from ..base.device import launch_counter
from ..ops import kernels
from ..ops.ans_kernel import LaneTensors
from ..ops.build import load as load_kernels
from ..ops.kernels import _check_cuda, _launch, _stream
from .gather import _bits

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
