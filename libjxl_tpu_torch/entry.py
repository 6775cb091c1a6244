"""The port's top-level entry points, the counterpart of __graft_entry__.py.

entry(device) returns the single-chip forward step of the flagship
compute path, the VarDCT decode of block-layout coefficients (dequant +
CfL + IDCT + XYB -> RGB), with its seeded inputs: on a card the step is
one dequant_idct8 launch and the colour transform
(kernels.decode_pixels_hybrid); on the CPU its plain twin.

dryrun_multichip(n, device) runs every sharded path of the port once on
an n-entry mesh (parallel/dryrun.py).
"""

from __future__ import annotations

import functools

import numpy as np

from .base.device import resolve_device
from .ops import kernels
from .ops.staging import to_device
from .vardct.quant_weights import library_tables


def entry(device="cuda"):
    """(fn, args): fn(*args) decodes one 256x256 group of seeded
    block-layout coefficients i32[3, 32, 32, 8, 8] (qf 64, zero CfL maps,
    the DCT8 dequant table, global scale 1024) to linear RGB f32[3, 256,
    256]. args are tensors on `device` ("cuda" raises without a card);
    fn is kernels.decode_pixels_hybrid with the step's scalars bound."""
    dev = resolve_device(device)
    nby, nbx = 32, 32  # one 256x256 group
    rng = np.random.default_rng(0)
    qcoeffs = rng.integers(-15, 15, (3, nby, nbx, 8, 8)).astype(np.int32)
    qf = np.full((nby, nbx), 64, dtype=np.int32)
    dc = rng.normal(0, 0.2, (3, nby, nbx)).astype(np.float32)
    tiles = -(-nby // 8)
    ytox = np.zeros((tiles, tiles), dtype=np.int32)
    ytob = np.zeros((tiles, tiles), dtype=np.int32)
    dm = library_tables()[0][0].astype(np.float32)
    fn = functools.partial(kernels.decode_pixels_hybrid,
                           inv_global_scale=1024.0, x_dm_mult=1.0,
                           b_dm_mult=1.0)
    return fn, to_device((qcoeffs, qf, dc, ytox, ytob, dm), dev)


def dryrun_multichip(n_devices: int, device="cuda",
                     big_mp: float = 64.0) -> dict:
    """parallel/dryrun.dryrun_multichip: every sharded path once on an
    n_devices mesh, each checked; returns its record."""
    from .parallel import dryrun

    return dryrun.dryrun_multichip(n_devices, device=device, big_mp=big_mp)
