"""Batched VarDCT serving decode on one device (the port of
libjxl_tpu/api/tpu_codec.py's decode_tpu_batch and
decode_tpu_batch_entropy paths).

N same-geometry, all-DCT8, XYB streams are entropy-decoded on the host by
the port's copy of the host decoder (prepare_batch), staged as one batch
(batch_from_numpy), and rendered by one BatchRenderer call of two
kernels: dequant + IDCT8 (dequant_idct8), then Gaborish -> EPF passes ->
sRGB u8 (render_tail).
decode_pipelined overlaps the host entropy of batch k+1 with the render
and readback of batch k. decode_batch_entropy moves the AC entropy decode
onto the device too: the host parses headers, DC and AC metadata
(prepare_batch_entropy), and the device runs the rANS kernel, the
placement of its tape and the same render.

Nothing here probes or imports JAX: the host layers it calls
(codestream header parsing, decode_vardct_frame, render.pipeline
helpers, the ops/ans_tpu plan builder) are the port's own copies of the
JAX package's NumPy and C host layers.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import time

import numpy as np
import torch
from torch import nn

from ..base.device import resolve_device
from ..base.status import JXLError
from ..io.bits import BitReader
from ..io.frame_header import FrameHeader
from ..ops import ans_kernel, ans_tpu, kernels, pipeline
from ..render.pipeline import _sad_mul_map, compute_sigma, gaborish_kernel
from ..vardct import ac_strategy as acs
from ..vardct.frame import decode_vardct_frame
from .codestream import _skip_or_decode_preview, parse_codestream_header


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """What one batch's render depends on besides its arrays (the JAX
    path's program key, minus the batch size)."""

    height: int  # block-padded
    width: int
    epf_iters: int
    gab: bool
    true_size: tuple | None  # (ysize, xsize) when not a multiple of 8
    x_dm_mult: float
    b_dm_mult: float
    pass0_sigma_scale: float
    pass2_sigma_scale: float
    channel_scale: tuple


def _parse(streams, **frame_kw):
    """Headers and frame decode of each stream, with the batch path's
    header gates. frame_kw goes to decode_vardct_frame."""
    if not streams:
        raise JXLError("batch decode: empty stream list")
    states, fhs = [], []
    for data in streams:
        r = BitReader(data)
        meta = parse_codestream_header(r)
        if not meta.m.xyb_encoded or meta.m.orientation != 1 \
                or meta.m.bit_depth.bits_per_sample > 8:
            raise JXLError("batch decode: stream needs host stages")
        if meta.m.num_extra_channels:
            raise JXLError("batch decode: extra channels")
        if meta.m.color_encoding.want_icc:
            raise JXLError("batch decode: CMS output stage")
        if meta.m.have_preview:
            _skip_or_decode_preview(r, meta)
        fh = FrameHeader(meta)
        fh.read(r)
        cap = {}

        def capture(state, cap=cap):
            cap["state"] = state
            state.restoration_done = True
            state.device_output_done = True

        decode_vardct_frame(r, fh, render_fn=capture, want_qimg=True,
                            **frame_kw)
        states.append(cap["state"])
        fhs.append(fh)
    return states, fhs


def _dequant_tables(st):
    return np.stack([st.matrices.dequant_matrix(0, c)
                     for c in range(3)]).astype(np.float32)


def _check_render_scope(st, fh, st0, fh0, dm0) -> None:
    """The render-config gates: one stream against the batch's first."""
    if st.patches is not None or st.splines is not None \
            or st.noise_lut is not None or fh.upsampling != 1:
        raise JXLError("batch decode: post-render features")
    if getattr(st, "color_factor", 84) != 84 \
            or getattr(st, "base_x", 0.0) != 0.0 \
            or getattr(st, "base_b", 1.0) != 1.0:
        raise JXLError("batch decode: custom color correlation")
    lf, lf0 = fh.loop_filter, fh0.loop_filter
    if (lf.epf_iters, lf.gab) != (lf0.epf_iters, lf0.gab) or any(
            getattr(lf, f) != getattr(lf0, f) for f in (
                "epf_pass0_sigma_scale", "epf_pass2_sigma_scale",
                "epf_border_sad_mul") if lf.epf_iters):
        raise JXLError("batch decode: mixed filter config")
    if not np.array_equal(_dequant_tables(st), dm0):
        raise JXLError("batch decode: mixed dequant tables")
    if (st.x_dm_mult, st.b_dm_mult) != (st0.x_dm_mult, st0.b_dm_mult):
        raise JXLError("batch decode: mixed qm scales")


def _stage(states, fhs, dm0):
    """The batch's render config and its arrays other than qimg: (qf, dc,
    ytox, ytob, igs, isp, dm, gabk, sad)."""
    fd0 = states[0].fd
    lf0 = fhs[0].loop_filter
    nby, nbx = fd0.ysize_blocks, fd0.xsize_blocks
    h, w = nby * 8, nbx * 8
    n = len(states)
    qf = np.stack([st.raw_quant_field for st in states]).astype(np.int32)
    dc = np.stack([st.dc for st in states]).astype(np.float32)
    ytox = np.stack([st.ytox_map for st in states]).astype(np.int32)
    ytob = np.stack([st.ytob_map for st in states]).astype(np.int32)
    igs = np.array([st.quantizer.inv_global_scale for st in states],
                   dtype=np.float32)
    if lf0.epf_iters > 0:
        # per-BLOCK sigma (64x less to upload than per-pixel); the EPF
        # kernel reads it per block
        isp = np.stack([
            compute_sigma(
                fh.loop_filter, st.quantizer.global_scale_float,
                st.raw_quant_field, st.epf_sharpness).astype(np.float32)
            for st, fh in zip(states, fhs)])
        sad = _sad_mul_map(h, w, lf0.epf_border_sad_mul).astype(
            np.float32)
    else:
        isp = np.zeros((n, nby, nbx), dtype=np.float32)
        sad = np.ones((h, w), dtype=np.float32)
    gabk = np.stack([gaborish_kernel(getattr(lf0, f"gab_{ch}_weight1"),
                                     getattr(lf0, f"gab_{ch}_weight2"))
                     for ch in "xyb"]).astype(np.float32) \
        if lf0.gab else np.zeros((3, 3, 3), dtype=np.float32)
    ts = (fd0.ysize, fd0.xsize) if (fd0.ysize, fd0.xsize) != (h, w) \
        else None
    config = BatchConfig(
        height=h, width=w, epf_iters=int(lf0.epf_iters), gab=bool(lf0.gab),
        true_size=ts, x_dm_mult=float(np.float32(states[0].x_dm_mult)),
        b_dm_mult=float(np.float32(states[0].b_dm_mult)),
        pass0_sigma_scale=float(np.float32(lf0.epf_pass0_sigma_scale)),
        pass2_sigma_scale=float(np.float32(lf0.epf_pass2_sigma_scale)),
        channel_scale=tuple(float(np.float32(v))
                            for v in lf0.epf_channel_scale))
    return config, (qf, dc, ytox, ytob, igs, isp, dm0, gabk, sad)


def prepare_batch(streams, num_threads: int = 0):
    """Entropy-decode `streams` on the host and stage them as one batch.

    Returns (config, args) with args = (qimg, qf, dc, ytox, ytob, igs,
    isp, dm, gabk, sad), the numpy arrays of the JAX path's
    prepare_tpu_batch. Raises JXLError when the streams are not one
    homogeneous all-DCT8 batch; callers decode such streams one by one."""
    states, fhs = _parse(streams, num_threads=num_threads)
    fd0 = states[0].fd
    dm0 = _dequant_tables(states[0])
    for st, fh in zip(states, fhs):
        fd = st.fd
        if (fd.ysize, fd.xsize) != (fd0.ysize, fd0.xsize):
            raise JXLError("batch decode: mixed geometry")
        if np.any(st.strategy[st.is_origin] != acs.DCT):
            raise JXLError("batch decode: non-DCT8 strategies")
        if getattr(st, "qimg", None) is None:
            if not st.qblocks:
                raise JXLError("batch decode: no coefficients")
            # single-group streams skip the bulk entropy path: assemble
            # the dense image from the per-block dict
            nby_, nbx_ = fd.ysize_blocks, fd.xsize_blocks
            plane5 = np.zeros((3, nby_, 8, nbx_, 8), dtype=np.int32)
            keys = np.array(list(st.qblocks.keys()), dtype=np.int64)
            vals = np.stack([np.asarray(v) for v in
                             st.qblocks.values()]).astype(np.int32)
            plane5[:, keys[:, 0], :, keys[:, 1], :] = \
                vals.reshape(-1, 3, 8, 8)
            st.qimg = plane5.reshape(3, nby_ * 8, nbx_ * 8)
        _check_render_scope(st, fh, states[0], fhs[0], dm0)
    qimg = np.stack([st.qimg for st in states])
    if np.abs(qimg).max() < (1 << 15):
        # quantized AC coefficients fit int16 on real streams: halves
        # the dominant upload (the kernel widens in-register)
        qimg = qimg.astype(np.int16)
    config, rest = _stage(states, fhs, dm0)
    return config, (qimg, *rest)


def prepare_batch_entropy(streams):
    """The host half of the device-entropy batch decode (the port of
    prepare_tpu_batch_entropy): headers, DC and AC metadata are decoded
    here, and the AC groups' raw rANS sections are laid out for the
    device (ops/ans_kernel.build_lane_plan).

    Returns (config, render_args, lane_plan); render_args are
    prepare_batch's arrays without qimg: (qf, dc, ytox, ytob, igs, isp,
    dm, gabk, sad). Raises JXLError outside the device kernel's scope, so
    that callers fall back to the host-entropy batch."""
    states, fhs = _parse(streams, ac_raw=True)
    datas, raws = [], []
    for st in states:
        raw = getattr(st, "ac_raw", None)
        if raw is None:
            raise JXLError("batch decode: no raw AC capture")
        frame_data, per_pass = raw
        datas.append(frame_data)
        raws.append(per_pass[0])
    try:
        plan = ans_tpu.build_plan(states, datas, raws, shared_tables=False)
        lane_plan = ans_kernel.build_lane_plan(plan)
    except ans_tpu.AnsTpuUnsupported as e:
        raise JXLError(f"batch decode: device entropy unsupported: {e}")
    dm0 = _dequant_tables(states[0])
    for st, fh in zip(states, fhs):
        _check_render_scope(st, fh, states[0], fhs[0], dm0)
    config, render_args = _stage(states, fhs, dm0)
    return config, render_args, lane_plan


class BatchRenderer(nn.Module):
    """Render a staged batch to sRGB u8 [B, H, W, 3] (block-padded).

    The counterpart of the JAX path's vmapped `one` closure: the tables
    the batch shares (dequant matrices, Gaborish kernels, SAD multiplier
    map) are buffers, and the batch dimension is written out."""

    def __init__(self, config: BatchConfig, dm, gab_kernels, sad_mul):
        super().__init__()
        self.config = config
        self.register_buffer("dm", torch.as_tensor(dm, dtype=torch.float32))
        self.register_buffer("gab_kernels",
                             torch.as_tensor(gab_kernels,
                                             dtype=torch.float32))
        self.register_buffer("sad_mul",
                             torch.as_tensor(sad_mul, dtype=torch.float32))

    def forward(self, qimg, qf, dc, ytox, ytob, inv_global_scale,
                inv_sigma):
        c = self.config
        return pipeline.decode_render_image(
            qimg, qf, dc, ytox, ytob, self.dm, inv_global_scale,
            c.x_dm_mult, c.b_dm_mult, self.gab_kernels if c.gab else None,
            inv_sigma, self.sad_mul, c.channel_scale, c.epf_iters,
            to_rgb="u8srgb", pass0_sigma_scale=c.pass0_sigma_scale,
            pass2_sigma_scale=c.pass2_sigma_scale, true_size=c.true_size)


def batch_from_numpy(args, config: BatchConfig, device="cuda"):
    """The numpy arguments of prepare_batch (or of the JAX path's
    prepare_tpu_batch, which are the same arrays) as a renderer and its
    inputs on `device`: `renderer(*inputs)` renders the batch. qimg may
    be a tensor already (the device-entropy path places it on the
    device)."""
    dev = resolve_device(device)
    qimg, qf, dc, ytox, ytob, igs, isp, dm, gabk, sad = args
    renderer = BatchRenderer(config, dm, gabk, sad).to(dev)
    inputs = tuple(a.to(dev) if torch.is_tensor(a)
                   else torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in (qimg, qf, dc, ytox, ytob, igs, isp))
    return renderer, inputs


class _Laps:
    """Host-clock seconds of a path's stages, written into `stages` when
    it is a dict: each call ends the stage begun by the previous one (or
    by construction), after synchronizing the device, so a device stage
    is timed to its end. With stages None it does nothing and never
    synchronizes."""

    def __init__(self, stages, dev):
        self.stages, self.dev = stages, dev
        self.t = time.perf_counter()

    def __call__(self, name: str):
        if self.stages is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        t = time.perf_counter()
        self.stages[name] = t - self.t
        self.t = t


def _render(config: BatchConfig, args, device, lap=None) -> list:
    """Upload, render and read back one staged batch: a list of u8
    [ysize, xsize, 3] images cropped to the frame's true size. `lap`, a
    _Laps, times the three stages."""
    lap = lap or _Laps(None, None)
    renderer, inputs = batch_from_numpy(args, config, device)
    lap("upload of the render arrays")
    with torch.inference_mode():
        px = renderer(*inputs)
        lap("render")
        u8 = px.cpu().numpy()
    lap("readback")
    th, tw = config.true_size or (config.height, config.width)
    return [u8[i, :th, :tw] for i in range(u8.shape[0])]


def decode_batch(streams, device="cuda", num_threads: int = 0) -> list:
    """Decode N same-geometry all-DCT8 streams with one batched render on
    `device`. Returns uint8 (H, W, 3) images in input order. Raises
    JXLError when the batch is not homogeneous; callers fall back to
    per-stream decode()."""
    config, args = prepare_batch(streams, num_threads=num_threads)
    return _render(config, args, device)


def decode_pipelined(streams, device="cuda", batch_size: int = 16,
                     num_threads: int = 0) -> list:
    """Pipelined serving decode: the caller's thread entropy-decodes
    batch k+1 (native C, which releases the GIL) while one worker thread
    uploads, renders and reads back batch k, so steady-state throughput
    is max(entropy, render + readback) rather than their sum.

    Returns uint8 (H, W, 3) images in input order; raises JXLError (like
    decode_batch) when any batch is outside the all-DCT8 serving scope."""
    if not streams:
        return []
    dev = resolve_device(device)
    bs = max(1, int(batch_size))
    out = [None] * len(streams)

    def drain(pending):
        fut, start = pending
        for j, img in enumerate(fut.result()):
            out[start + j] = img

    with cf.ThreadPoolExecutor(max_workers=1) as ex:
        pending = None
        try:
            for start in range(0, len(streams), bs):
                config, args = prepare_batch(streams[start:start + bs],
                                             num_threads=num_threads)
                # submit before draining batch k-1, so the worker rolls
                # straight from one batch into the next
                job = ex.submit(_render, config, args, dev)
                if pending is not None:
                    drain(pending)
                pending = (job, start)
        finally:
            if pending is not None:
                drain(pending)
    return out


def _host_fallback(streams, device, reason: str):
    """decode_batch of `streams`, reported as the device-entropy path's
    fallback; a host decode that fails too carries `reason` as a note."""
    try:
        images = decode_batch(streams, device)
    except JXLError as e:
        e.add_note(f"device-entropy fallback: {reason}")
        raise
    return images, {"path": "host_entropy", "fallback": reason}


def decode_batch_entropy(streams, device="cuda",
                         stages: dict | None = None):
    """Batch decode with the AC entropy decode on `device` (the port of
    decode_tpu_batch_entropy). Returns (images, info): uint8 (H, W, 3)
    images in input order, and info["path"] == "device_entropy".

    On `device`: upload of the lane plan; the rANS decode
    (kernels.ans_decode); the placement of its tape into qimg
    (ans_kernel.place), which never leaves the device; upload of the
    render arrays; BatchRenderer (dequant_idct8 + render_tail); one readback
    of the images. The lanes' ok flags and step counts are read back
    before the placement, which reads only the tape rows that some lane
    wrote. A dict `stages` receives each stage's host-clock seconds, the
    device synchronized at each stage's end (which costs the path its
    overlap, so time the end-to-end rate without it).

    Streams outside the device kernel's scope fall back, before anything
    is uploaded, to decode_batch with info["path"] == "host_entropy" and
    info["fallback"] saying why. A lane that is not ok (a corrupt stream,
    since t_alloc is the plan's structural bound) raises JXLError naming
    the lanes; the batch is not decoded again on the host. A kernel that
    fails to build or launch raises."""
    dev = resolve_device(device)
    lap = _Laps(stages, dev)
    try:
        config, render_args, lane_plan = prepare_batch_entropy(streams)
    except JXLError as e:
        return _host_fallback(streams, dev, str(e))
    lap("host parse + plan + lane plan")
    with torch.inference_mode():
        lane_tensors = lane_plan.to(dev)
        lap("upload of the lane plan")
        tape, ok, steps = kernels.ans_decode(lane_tensors)
        lap("ans_decode")
        flags = torch.stack([ok.to(torch.int32), steps]).cpu().numpy()
        bad = np.flatnonzero(flags[0] == 0)
        if bad.size:
            raise JXLError(
                f"batch decode: device kernel flagged {bad.size} lanes "
                f"not ok: {bad[:16].tolist()}"
                + (" ..." if bad.size > 16 else ""))
        qimg = ans_kernel.place(tape[:max(int(flags[1].max()), 1)],
                                lane_plan)
        del tape, lane_tensors
        lap("ok/steps readback + place")
    return _render(config, (qimg, *render_args), dev, lap), {
        "path": "device_entropy"}
