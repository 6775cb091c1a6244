"""Batched VarDCT serving decode on one device (the port of
libjxl_tpu/api/tpu_codec.py's decode_tpu_batch path).

N same-geometry, all-DCT8, XYB streams are entropy-decoded on the host by
libjxl_tpu's own decoder (prepare_batch), staged as one batch
(batch_from_numpy), and rendered by one BatchRenderer call: dequant +
IDCT8 (kernel) -> Gaborish -> EPF passes (kernel) -> sRGB u8.
decode_pipelined overlaps the host entropy of batch k+1 with the render
and readback of batch k.

Nothing here probes or imports JAX: the host layers it calls
(codestream header parsing, decode_vardct_frame, render.pipeline
helpers) are plain NumPy and C.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses

import numpy as np
import torch
from torch import nn

from libjxl_tpu.api.codestream import (_skip_or_decode_preview,
                                       parse_codestream_header)
from libjxl_tpu.base.status import JXLError
from libjxl_tpu.io.bits import BitReader
from libjxl_tpu.io.frame_header import FrameHeader
from libjxl_tpu.render.pipeline import (_sad_mul_map, compute_sigma,
                                        gaborish_kernel)
from libjxl_tpu.vardct import ac_strategy as acs
from libjxl_tpu.vardct.frame import decode_vardct_frame

from ..base.device import resolve_device
from ..ops import pipeline


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


def prepare_batch(streams, num_threads: int = 0):
    """Entropy-decode `streams` on the host and stage them as one batch.

    Returns (config, args) with args = (qimg, qf, dc, ytox, ytob, igs,
    isp, dm, gabk, sad), the numpy arrays of the JAX path's
    prepare_tpu_batch. Raises JXLError when the streams are not one
    homogeneous all-DCT8 batch; callers decode such streams one by one."""
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
                            num_threads=num_threads)
        states.append(cap["state"])
        fhs.append(fh)
    fd0 = states[0].fd
    lf0 = fhs[0].loop_filter
    dm0 = np.stack([states[0].matrices.dequant_matrix(0, c)
                    for c in range(3)]).astype(np.float32)
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
        if st.patches is not None or st.splines is not None \
                or st.noise_lut is not None or fh.upsampling != 1:
            raise JXLError("batch decode: post-render features")
        if getattr(st, "color_factor", 84) != 84 \
                or getattr(st, "base_x", 0.0) != 0.0 \
                or getattr(st, "base_b", 1.0) != 1.0:
            raise JXLError("batch decode: custom color correlation")
        lf = fh.loop_filter
        if (lf.epf_iters, lf.gab) != (lf0.epf_iters, lf0.gab) or any(
                getattr(lf, f) != getattr(lf0, f) for f in (
                    "epf_pass0_sigma_scale", "epf_pass2_sigma_scale",
                    "epf_border_sad_mul") if lf.epf_iters):
            raise JXLError("batch decode: mixed filter config")
        dm = np.stack([st.matrices.dequant_matrix(0, c)
                       for c in range(3)]).astype(np.float32)
        if not np.array_equal(dm, dm0):
            raise JXLError("batch decode: mixed dequant tables")
        if (st.x_dm_mult, st.b_dm_mult) != (states[0].x_dm_mult,
                                            states[0].b_dm_mult):
            raise JXLError("batch decode: mixed qm scales")
    nby, nbx = fd0.ysize_blocks, fd0.xsize_blocks
    h, w = nby * 8, nbx * 8
    n = len(states)
    qimg = np.stack([st.qimg for st in states])
    if np.abs(qimg).max() < (1 << 15):
        # quantized AC coefficients fit int16 on real streams: halves
        # the dominant upload (the kernel widens in-register)
        qimg = qimg.astype(np.int16)
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
    return config, (qimg, qf, dc, ytox, ytob, igs, isp, dm0, gabk, sad)


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


def batch_from_numpy(args, config: BatchConfig, device):
    """The numpy arguments of prepare_batch (or of the JAX path's
    prepare_tpu_batch, which are the same arrays) as a renderer and its
    inputs on `device`: `renderer(*inputs)` renders the batch."""
    dev = resolve_device(device)
    qimg, qf, dc, ytox, ytob, igs, isp, dm, gabk, sad = args
    renderer = BatchRenderer(config, dm, gabk, sad).to(dev)
    inputs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in (qimg, qf, dc, ytox, ytob, igs, isp))
    return renderer, inputs


def _render(config: BatchConfig, args, device) -> list:
    """Upload, render and read back one staged batch: a list of u8
    [ysize, xsize, 3] images cropped to the frame's true size."""
    renderer, inputs = batch_from_numpy(args, config, device)
    with torch.inference_mode():
        u8 = renderer(*inputs).cpu().numpy()
    th, tw = config.true_size or (config.height, config.width)
    return [u8[i, :th, :tw] for i in range(u8.shape[0])]


def decode_batch(streams, device, num_threads: int = 0) -> list:
    """Decode N same-geometry all-DCT8 streams with one batched render on
    `device`. Returns uint8 (H, W, 3) images in input order. Raises
    JXLError when the batch is not homogeneous; callers fall back to
    per-stream decode()."""
    config, args = prepare_batch(streams, num_threads=num_threads)
    return _render(config, args, device)


def decode_pipelined(streams, device, batch_size: int = 16,
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
