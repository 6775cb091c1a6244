"""VarDCT decode and encode on one device (the port of
libjxl_tpu/api/tpu_codec.py's decode_tpu_batch, decode_tpu_batch_entropy,
single-image decode and encode_lossy_tpu paths).

N same-geometry, all-DCT8, XYB streams are entropy-decoded on the host by
the port's copy of the host decoder (prepare_batch), staged as one batch,
and rendered by render_batch in two kernels: dequant + IDCT8
(dequant_idct8), then Gaborish -> EPF passes -> sRGB u8 (render_tail).
decode_pipelined overlaps the host entropy of batch k+1 with the render
and readback of batch k; decode_batch_sharded splits one batch over the
devices of a mesh (parallel/sharding.Mesh), one render a device.
decode_batch_entropy moves the AC entropy decode onto the device too: the
host parses headers, DC and AC metadata (prepare_batch_entropy), and the
device runs the rANS kernel, the placement of its tape and the same
render.

make_device_render is the single-image render that codestream.decode,
decode_frames and decode_batch take with a device: one frame of any of
the 27 AC strategies (dequant_idct8 over every block, the other
strategies' inverse transforms as torch ops, render_tail), or a YCbCr
frame (render_tail for its filters), with the reference's scope gates
and path records; decode is its first-frame entry.

encode_lossy_tpu, codestream.encode_lossy's route at efforts <= 3, runs
the encode step (pipeline.encode_step: XYB, adaptive quant field, inverse
Gaborish, DCT8, CfL, dead-zone quantization; torch ops, no hand kernel)
on the device and the entropy coding on the host.

Each device step is a program (ops/programs.py, a cached CUDA graph, the
counterpart of the JAX package's jitted programs): "batch" (_render,
the JAX _BATCH_PROGS; decode_batch, decode_pipelined and each device of
decode_batch_sharded), "entropy" (decode_batch_entropy, _ENTROPY_PROGS),
"dec_image" (render_image, _jitted().dec_image), "dec_sub"
(_render_subsampled_device, _jitted_sub) and "enc" (encode_lossy_tpu,
_jitted().enc with srgb2lin).

Nothing here probes or imports JAX: the host layers it calls
(codestream header parsing, decode_vardct_frame, render.pipeline
helpers, the lane plan of ops/ans_kernel.lane_plan_from_sections) are
the port's own copies of the JAX package's NumPy and C host layers.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses

import numpy as np
import torch

from ..base.device import resolve_device, span, spanned
from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from ..io.frame_header import FrameHeader
from ..ops import ans_kernel, ans_tpu, kernels, pipeline, programs
from ..ops.staging import (block_sigma, dequant_tables, f32, gab_kernels,
                           sad_mul)
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
    # the JAX path's program key minus the batch size, as its
    # _BATCH_PROGS stores it (the sigma scales as the header holds them)
    key: tuple = ()


def _parse(streams, **frame_kw):
    """Headers and frame decode of each stream, with the batch path's
    header gates. frame_kw goes to decode_vardct_frame."""
    if not streams:
        raise JXLError("batch decode: empty stream list")
    states, fhs = [], []
    for data in streams:
        with span("jxl.headers"):
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
    if not np.array_equal(dequant_tables(st), dm0):
        raise JXLError("batch decode: mixed dequant tables")
    if (st.x_dm_mult, st.b_dm_mult) != (st0.x_dm_mult, st0.b_dm_mult):
        raise JXLError("batch decode: mixed qm scales")


def _stage(states, fhs, dm0):
    """The batch's render config and its arrays other than qimg: (qf, dc,
    ytox, ytob, igs, isp, dm, gabk, sad)."""
    fd0 = states[0].fd
    lf0 = fhs[0].loop_filter
    h, w = fd0.ysize_blocks * 8, fd0.xsize_blocks * 8
    qf = np.stack([st.raw_quant_field for st in states]).astype(np.int32)
    dc = np.stack([st.dc for st in states]).astype(np.float32)
    ytox = np.stack([st.ytox_map for st in states]).astype(np.int32)
    ytob = np.stack([st.ytob_map for st in states]).astype(np.int32)
    igs = np.array([st.quantizer.inv_global_scale for st in states],
                   dtype=np.float32)
    isp = np.stack([block_sigma(st, fh.loop_filter)
                    for st, fh in zip(states, fhs)])
    sad = sad_mul(lf0, h, w)
    gabk = gab_kernels(lf0)
    if gabk is None:
        gabk = np.zeros((3, 3, 3), dtype=np.float32)
    ts = (fd0.ysize, fd0.xsize) if (fd0.ysize, fd0.xsize) != (h, w) \
        else None
    xdm = float(np.float32(states[0].x_dm_mult))
    bdm = float(np.float32(states[0].b_dm_mult))
    cs = tuple(float(np.float32(v)) for v in lf0.epf_channel_scale)
    config = BatchConfig(
        height=h, width=w, epf_iters=int(lf0.epf_iters), gab=bool(lf0.gab),
        true_size=ts, x_dm_mult=xdm, b_dm_mult=bdm,
        pass0_sigma_scale=float(np.float32(lf0.epf_pass0_sigma_scale)),
        pass2_sigma_scale=float(np.float32(lf0.epf_pass2_sigma_scale)),
        channel_scale=cs,
        key=(h, w, int(lf0.epf_iters), bool(lf0.gab), ts, xdm, bdm,
             float(lf0.epf_pass0_sigma_scale),
             float(lf0.epf_pass2_sigma_scale), cs))
    return config, (qf, dc, ytox, ytob, igs, isp, dm0, gabk, sad)


def prepare_batch(streams, num_threads: int = 0):
    """Entropy-decode `streams` on the host and stage them as one batch.

    Returns (config, args) with args = (qimg, qf, dc, ytox, ytob, igs,
    isp, dm, gabk, sad), the numpy arrays of the JAX path's
    prepare_tpu_batch. Raises JXLError when the streams are not one
    homogeneous all-DCT8 batch; callers decode such streams one by one."""
    states, fhs = _parse(streams, num_threads=num_threads)
    with span("jxl.stage"):
        fd0 = states[0].fd
        dm0 = dequant_tables(states[0])
        for st, fh in zip(states, fhs):
            fd = st.fd
            if (fd.ysize, fd.xsize) != (fd0.ysize, fd0.xsize):
                raise JXLError("batch decode: mixed geometry")
            if np.any(st.strategy[st.is_origin] != acs.DCT):
                raise JXLError("batch decode: non-DCT8 strategies")
            if getattr(st, "qimg", None) is None and not st.qblocks:
                raise JXLError("batch decode: no coefficients")
            _dense_qimg(st)
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
    device straight from the sections (ops/ans_kernel.
    lane_plan_from_sections; the tests hold it to the oracle route,
    ops/ans_tpu.build_plan then ans_kernel.build_lane_plan, which builds
    the same LanePlan with per-chain metadata for the NumPy simulator).

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
        with span("jxl.entropy.plan"):
            lane_plan = ans_kernel.lane_plan_from_sections(states, datas,
                                                           raws)
    except ans_tpu.AnsTpuUnsupported as e:
        raise JXLError(f"batch decode: device entropy unsupported: {e}")
    with span("jxl.stage"):
        dm0 = dequant_tables(states[0])
        for st, fh in zip(states, fhs):
            _check_render_scope(st, fh, states[0], fhs[0], dm0)
        config, render_args = _stage(states, fhs, dm0)
    return config, render_args, lane_plan


def render_batch(qimg, qf, dc, ytox, ytob, inv_global_scale, inv_sigma, dm,
                 gab_kernels, sad_mul, config: BatchConfig):
    """The batch render, sRGB u8 [B, H, W, 3] (block-padded): the body of
    the "batch" program (the JAX path's _BATCH_PROGS) that _render runs,
    and of the "entropy" program after the placement; gab_kernels is read
    when config.gab is set."""
    c = config
    return pipeline.decode_render_image(
        qimg, qf, dc, ytox, ytob, dm, inv_global_scale, c.x_dm_mult,
        c.b_dm_mult, gab_kernels if c.gab else None, inv_sigma, sad_mul,
        c.channel_scale, c.epf_iters, to_rgb="u8srgb",
        pass0_sigma_scale=c.pass0_sigma_scale,
        pass2_sigma_scale=c.pass2_sigma_scale, true_size=c.true_size)


def batch_key(config: BatchConfig, batch: int) -> tuple:
    """The "batch" program's key: the JAX path's _BATCH_PROGS key."""
    return (batch, *config.key)


def _crop(config: BatchConfig, u8) -> list:
    th, tw = config.true_size or (config.height, config.width)
    return [u8[i, :th, :tw] for i in range(u8.shape[0])]


def _render(config: BatchConfig, args, device) -> list:
    """Upload, render and read back one staged batch: a list of u8
    [ysize, xsize, 3] images cropped to the frame's true size. Runs the
    "batch" program, whose input slots take the arrays straight from the
    host, and reads its output back before the program runs again (so
    decode_pipelined's worker may render while the caller's thread
    stages)."""
    u8 = programs.run("batch", batch_key(config, len(args[0])),
                      render_batch, *args, config=config,
                      device=resolve_device(device), readback=True)
    return _crop(config, u8)


@spanned("jxl.decode_batch")
def decode_batch(streams, device="cuda", num_threads: int = 0) -> list:
    """Decode N same-geometry all-DCT8 streams with one batched render on
    `device`. Returns uint8 (H, W, 3) images in input order. Raises
    JXLError when the batch is not homogeneous; callers fall back to
    per-stream decode()."""
    config, args = prepare_batch(streams, num_threads=num_threads)
    return _render(config, args, device)


@spanned("jxl.decode_batch_sharded")
def decode_batch_sharded(streams, mesh=None, num_threads: int = 0) -> list:
    """The data-parallel serving decode (the port of
    decode_tpu_batch_sharded): one prepare_batch of `streams` on the host,
    the batch axis split over every device of `mesh` (a
    parallel/sharding.Mesh, every card by default), each shard rendered
    and read back through _render, the "batch" program of its device (on
    one device, a mesh entry shares decode_batch's program). Returns
    uint8 (H, W, 3) images in input order, cropped as decode_batch crops
    them; raises JXLError when the batch does not divide across the
    devices, or (like decode_batch) is not one homogeneous all-DCT8
    batch."""
    from ..parallel.sharding import make_mesh

    mesh = make_mesh() if mesh is None else mesh
    devs = list(mesh.devices.flat)
    if len(streams) % len(devs):
        raise JXLError("sharded batch decode: batch size must divide "
                       f"across {len(devs)} devices")
    config, args = prepare_batch(streams, num_threads=num_threads)
    per = len(streams) // len(devs)
    out = []
    for i, dev in enumerate(devs):
        # the first 7 arrays carry the batch axis; dm, gabk and sad are
        # shared
        out += _render(config, tuple(
            a[i * per:(i + 1) * per] if k < 7 else a
            for k, a in enumerate(args)), dev)
    return out


@spanned("jxl.decode_pipelined")
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


def entropy_key(config: BatchConfig, lp) -> tuple:
    """The "entropy" program's key: the JAX path's _ENTROPY_PROGS key but
    its last field (the JAX kernel's interpret mode, which the port does
    not have), the lane-layout fields computed from the port's LanePlan
    as the JAX ServePlan computes them. lp is the ans_kernel.program_plan
    the program takes, whose alias_rows is rounded."""
    return (lp.B, *config.key, *ans_kernel.program_key(lp))


def _entropy_program(lanes, inv_order, render_args, geometry, las, t_alloc,
                     config):
    """The device-entropy batch in one program (the JAX path's
    _ENTROPY_PROGS form): K3 over the whole t_alloc tape, its placement,
    the batch render. Returns (u8 [B, H, W, 3], ok bool[L])."""
    lt = ans_kernel.LaneTensors(**lanes, las=las, t_alloc=t_alloc)
    tape, ok, _ = kernels.ans_decode(lt)
    qimg = ans_kernel.place(tape, geometry, inv_order)
    return render_batch(qimg, *render_args, config=config), ok


def _not_ok(ok) -> None:
    bad = np.flatnonzero(np.asarray(ok) == 0)
    if bad.size:
        raise JXLError(
            f"batch decode: device kernel flagged {bad.size} lanes "
            f"not ok: {bad[:16].tolist()}"
            + (" ..." if bad.size > 16 else ""))


@spanned("jxl.decode_batch_entropy")
def decode_batch_entropy(streams, device="cuda"):
    """Batch decode with the AC entropy decode on `device` (the port of
    decode_tpu_batch_entropy). Returns (images, info): uint8 (H, W, 3)
    images in input order, and info["path"] == "device_entropy".

    On `device`, the "entropy" program (the JAX path's fused program) on
    the batch's ans_kernel.program_plan: the rANS decode
    (kernels.ans_decode) into a tape of the plan's structural bound
    rounded up to ans_kernel.TAPE_STEP rows, the placement of the whole
    tape into qimg (ans_kernel.place), which never leaves the device, and
    the batch render (dequant_idct8 + render_tail); then one readback of
    the images and the lanes' ok flags. Batches of one geometry and one
    encoder setting share the program.

    Streams outside the device kernel's scope fall back, before anything
    is uploaded, to decode_batch with info["path"] == "host_entropy" and
    info["fallback"] saying why. A lane that is not ok (a corrupt stream,
    since t_alloc is the plan's structural bound) raises JXLError naming
    the lanes; the batch is not decoded again on the host. A kernel that
    fails to build or launch raises."""
    dev = resolve_device(device)
    try:
        config, render_args, lane_plan = prepare_batch_entropy(streams)
    except JXLError as e:
        return _host_fallback(streams, dev, str(e))
    with span("jxl.entropy.plan"):
        lp = ans_kernel.program_plan(lane_plan)
    u8, ok = programs.run(
        "entropy", entropy_key(config, lp), _entropy_program, lp.arrays(),
        lp.inv_order, render_args, geometry=ans_kernel.Geometry.of(lp),
        las=lp.las, t_alloc=lp.t_alloc, config=config, device=dev,
        readback=True)
    _not_ok(ok)
    return _crop(config, u8), {"path": "device_entropy"}


# ------------------------------------------------ the single-image render


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _gather_tiles(qimg, ys, xs, rows, cols, pad):
    """(pad, 3, rows*cols) int32 tiles from the dense coefficient image
    at block origins (ys, xs) — one fancy-indexed numpy gather."""
    n = len(ys)
    w = qimg.shape[-1]
    base = (ys * 8 * w + xs * 8).astype(np.int64)
    pattern = (np.arange(rows)[:, None] * w
               + np.arange(cols)[None, :]).reshape(-1)
    idx = base[:, None] + pattern[None, :]
    flat = qimg.reshape(3, -1)
    out = np.zeros((pad, 3, rows * cols), dtype=np.int32)
    out[:n] = flat[:, idx].transpose(1, 0, 2)
    return out


def _prepare_batches(state, qimg):
    """Group non-DCT8 blocks by strategy into padded device batches.

    Returns (extra_tiles list, tile_shapes, size_passes list, size_shapes,
    class_map i32[nby, nbx]) of numpy arrays (the JAX form also returns
    a per-pixel dct8_mask, which class_map replaces), or None when an origin is not aligned to its own tile size
    (host fallback; real encoders always emit aligned merges)."""
    from ..ops.dct import resample_scales
    from ..ops.pipeline import special_matrix

    fd = state.fd
    nby, nbx = fd.ysize_blocks, fd.xsize_blocks
    inv_gs = state.quantizer.inv_global_scale
    strat_map = state.strategy
    origins = state.is_origin
    used = np.unique(strat_map[origins])
    extra, shapes = [], []
    size_passes, size_shapes = [], []
    class_map = np.zeros((nby, nbx), dtype=np.int32)
    for s in used:
        s = int(s)
        if s == acs.DCT:
            continue
        cx, cy = acs.COVERED_X[s], acs.COVERED_Y[s]
        rows, cols = cy * 8, cx * 8
        kind = acs.QUANT_TABLE[s]
        pos = np.argwhere(origins & (strat_map == s))
        ys, xs = pos[:, 0], pos[:, 1]
        n = len(ys)
        if (cy > 1 and (ys % cy).any()) or (cx > 1 and (xs % cx).any()):
            return None  # unaligned origin: host render
        if (nby * 8) % rows != 0 or (nbx * 8) % cols != 0:
            # the batched scatter also reshapes the padded grid by the
            # tile size; odd-size images with large merges render on host
            if max(rows, cols) > 8:
                return None
        plain = s in (acs.DCT16X16, acs.DCT32X32, acs.DCT16X8, acs.DCT8X16,
                      acs.DCT32X8, acs.DCT8X32, acs.DCT32X16, acs.DCT16X32,
                      acs.DCT64X64, acs.DCT64X32, acs.DCT32X64)
        if plain and max(rows, cols) <= 64 \
                and (nby * 8) % rows == 0 and (nbx * 8) % cols == 0:
            # dense full-grid pass (decode_size_pass): no gathers; it
            # needs the padded grid divisible by the tile
            wr, wc = min(rows, cols), max(rows, cols)
            dm = np.stack([state.matrices.dequant_matrix(kind, c)
                           for c in range(3)]).astype(np.float32)
            lh, lw = min(cy, cx), max(cy, cx)
            mask_wide = np.zeros((wr, wc), dtype=bool)
            mask_wide[:lh, :lw] = True
            size_passes.append(dict(
                dm_tile=dm.reshape(3, rows, cols),
                llf_sy=resample_scales(lh, lh * 8).astype(np.float32),
                llf_sx=resample_scales(lw, lw * 8).astype(np.float32),
                llf_mask=mask_wide.reshape(rows, cols)))
            size_shapes.append((rows, cols))
            class_map[strat_map == s] = len(size_passes)
            continue
        class_map[strat_map == s] = -1
        pad = _next_pow2(n)
        q = _gather_tiles(qimg, ys, xs, rows, cols, pad)
        quant = state.raw_quant_field[ys, xs].astype(np.float64)
        scaled = np.zeros(pad, dtype=np.float32)
        scaled[:n] = inv_gs / quant
        ty, tx = ys // 8, xs // 8
        x_cc = np.zeros(pad, dtype=np.float32)
        b_cc = np.zeros(pad, dtype=np.float32)
        x_cc[:n] = state.ytox(state.ytox_map[ty, tx].astype(np.float64))
        b_cc[:n] = state.ytob(state.ytob_map[ty, tx].astype(np.float64))
        ys_p = np.zeros(pad, dtype=np.int32)
        xs_p = np.zeros(pad, dtype=np.int32)
        ys_p[:n] = ys // cy  # tile indices in the (rows, cols) grid
        xs_p[:n] = xs // cx
        dm = np.stack([state.matrices.dequant_matrix(kind, c)
                       for c in range(3)]).astype(np.float32)
        batch = dict(ys=ys_p, xs=xs_p, scaled=scaled, x_cc=x_cc, b_cc=b_cc)
        if rows == 8 and cols == 8:
            batch["q"] = q
            batch["dm"] = dm.reshape(3, 64)
            batch["mat"] = special_matrix(s)
            dc = np.zeros((pad, 3), dtype=np.float32)
            dc[:n] = state.dc[:, ys, xs].T
            batch["dc"] = dc
        else:
            wr, wc = min(rows, cols), max(rows, cols)
            batch["q"] = q.reshape(pad, 3, wr, wc)
            batch["dm"] = dm
            dc = np.zeros((pad, 3, cy, cx), dtype=np.float32)
            dcp = np.pad(state.dc, ((0, 0), (0, cy), (0, cx)))
            dc_pat = (np.arange(cy)[:, None] * (nbx + cx)
                      + np.arange(cx)[None, :]).reshape(-1)
            dc_idx = (ys * (nbx + cx) + xs)[:, None] + dc_pat[None, :]
            dc[:n] = dcp.reshape(3, -1)[:, dc_idx].transpose(
                1, 0, 2).reshape(n, 3, cy, cx)
            batch["dc"] = dc
            lh, lw = min(cy, cx), max(cy, cx)
            batch["llf_sy"] = resample_scales(lh, lh * 8).astype(np.float32)
            batch["llf_sx"] = resample_scales(lw, lw * 8).astype(np.float32)
        extra.append(batch)
        shapes.append((rows, cols))
    return extra, tuple(shapes), size_passes, tuple(size_shapes), class_map


def _qblocks_from_qimg(state):
    """Rebuild the per-block dict from the dense coefficient image so the
    host render path can take over (rare fallback)."""
    qimg = state.qimg
    for s in np.unique(state.strategy[state.is_origin]):
        s = int(s)
        cx, cy = acs.COVERED_X[s], acs.COVERED_Y[s]
        pos = np.argwhere(state.is_origin & (state.strategy == s))
        n = len(pos)
        tiles = _gather_tiles(qimg, pos[:, 0], pos[:, 1], cy * 8, cx * 8, n)
        for i, (by, bx) in enumerate(pos):
            state.qblocks[(int(by), int(bx))] = tiles[i].astype(np.int64)


def _dense_qimg(state) -> None:
    """state.qimg, the dense coefficient image: when the bulk entropy path
    did not run (small image / lz77 / prefix streams), assembled from the
    per-block dict. The one-cell blocks (every block of an all-DCT8
    frame) land in one scatter, the larger transforms one by one."""
    if getattr(state, "qimg", None) is not None:
        return
    nby, nbx = state.fd.ysize_blocks, state.fd.xsize_blocks
    plane5 = np.zeros((3, nby, 8, nbx, 8), dtype=np.int32)
    qimg = plane5.reshape(3, nby * 8, nbx * 8)
    ones, ys, xs = [], [], []
    for (by, bx), blk in state.qblocks.items():
        s = int(state.strategy[by, bx])
        cx, cy = acs.COVERED_X[s], acs.COVERED_Y[s]
        if cx == cy == 1:
            ones.append(np.asarray(blk))
            ys.append(by)
            xs.append(bx)
        else:
            qimg[:, by * 8:(by + cy) * 8, bx * 8:(bx + cx) * 8] = \
                np.asarray(blk).reshape(3, cy * 8, cx * 8)
    if ones:
        plane5[:, ys, :, xs, :] = np.stack(ones).reshape(-1, 3, 8, 8)
    state.qimg = qimg


@spanned("jxl.stage")
def stage_image(state, fh, direct_u8: bool):
    """The host-side inputs of one XYB frame's device render: (args,
    kwargs) of pipeline.decode_render_image, numpy arrays in the types
    the kernels take (i32 coefficients, quant field and CfL maps, f32
    DC), to_device'd before the call; None when a transform's layout
    keeps the frame on the host. direct_u8: the render ends in the sRGB
    u8 write (else XYB)."""
    _dense_qimg(state)
    prep = _prepare_batches(state, state.qimg)
    if prep is None:
        return None
    extra, shapes, size_passes, size_shapes, class_map = prep
    fd = state.fd
    h, w = fd.ysize_blocks * 8, fd.xsize_blocks * 8
    lf = fh.loop_filter
    args = (state.qimg.astype(np.int32, copy=False),
            state.raw_quant_field.astype(np.int32, copy=False),
            state.dc.astype(np.float32), state.ytox_map.astype(np.int32),
            state.ytob_map.astype(np.int32), dequant_tables(state),
            f32(state.quantizer.inv_global_scale), f32(state.x_dm_mult),
            f32(state.b_dm_mult), gab_kernels(lf), block_sigma(state, lf),
            sad_mul(lf, h, w), tuple(f32(v) for v in lf.epf_channel_scale),
            int(lf.epf_iters))
    kwargs = dict(
        to_rgb="u8srgb" if direct_u8 else False,
        pass0_sigma_scale=f32(lf.epf_pass0_sigma_scale),
        pass2_sigma_scale=f32(lf.epf_pass2_sigma_scale),
        extra_tiles=extra, tile_shapes=shapes,
        size_passes=size_passes, size_shapes=size_shapes,
        class_map=class_map,
        true_size=(fd.ysize, fd.xsize)
        if (fd.ysize, fd.xsize) != (h, w) else None)
    return args, kwargs


def image_key(kw: dict) -> tuple:
    """The "dec_image" program's key, the static arguments of the JAX
    package's jitted dec_image: (epf_iters, tile_shapes, gab, to_rgb,
    size_shapes, true_size), from decode_render_image's arguments."""
    return (kw["epf_iters"], kw["tile_shapes"] or (),
            kw["gab_kernels"] is not None, kw["to_rgb"],
            kw["size_shapes"] or (), kw["true_size"])


_IMAGE_ARGS = ("qimg", "qf", "dc", "ytox_map", "ytob_map", "dm",
               "inv_global_scale", "x_dm_mult", "b_dm_mult", "gab_kernels",
               "inv_sigma", "sad_mul", "channel_scale", "epf_iters")


def render_image(args, kw, device):
    """pipeline.decode_render_image(*args, **kw) through the "dec_image"
    program (the JAX package's jitted dec_image) on `device`, read back
    as numpy: the single-image render of make_device_render and the
    strips of vardct/low_memory. args and kw as stage_image gives them
    (numpy arrays, the program's inputs; inv_global_scale goes in as one
    f32 of data, as the JAX program takes it)."""
    named = dict(zip(_IMAGE_ARGS, args), **kw)
    named["inv_global_scale"] = np.asarray(named["inv_global_scale"],
                                           dtype=np.float32)
    return programs.run("dec_image", image_key(named),
                        pipeline.decode_render_image, device=device,
                        readback=True, **named)


def _render_subsampled_device(state, fh, out, dev) -> bool:
    """The device render of a YCbCr frame (the JPEG recompression decode
    path): pipeline.decode_render_subsampled (dequant + IDCT8, libjxl's
    linear chroma upsampling, one render_tail launch for the filters,
    BT.601, the u8 write). Returns True when final pixels were produced in
    out['u8']; False when the frame is outside its scope (host render).
    The host's part (the coefficient planes, DC, scaled quant maps and
    dequant tables) is a jxl.stage span."""
    if not out.get("want_u8", False):
        return False
    if state.patches is not None or state.splines is not None \
            or state.noise_lut is not None:
        return False
    if fh.upsampling != 1 \
            or fh.nonserialized_metadata.m.num_extra_channels:
        return False
    is444 = getattr(state, "qblocks_sub", None) is None
    if is444:
        # 444 YCbCr rides the regular dense layout; all-DCT8 only
        if getattr(state, "qimg", None) is None:
            return False
        strategies = np.unique(state.strategy[state.is_origin])
        if not all(int(s) == acs.DCT for s in strategies):
            return False
        # the dense host path applies CfL and the x/b qm multipliers;
        # this lean YCbCr render assumes they are neutral
        if np.any(state.ytox_map) or np.any(state.ytob_map) \
                or state.x_dm_mult != 1.0 or state.b_dm_mult != 1.0 \
                or state.base_x != 0.0 or state.base_b != 0.0:
            return False
    elif getattr(state, "dc_sub", None) is None:
        return False
    with span("jxl.stage"):
        args, kwargs, key = _stage_subsampled(state, fh, is444)
    out["u8"] = programs.run(
        "dec_sub", key, pipeline.decode_render_subsampled, *args,
        device=dev, readback=True, **kwargs)
    out["path"] = "device:u8-ycbcr"
    state.device_output_done = True
    return True


def _stage_subsampled(state, fh, is444: bool):
    """The "dec_sub" program's inputs, (args, kwargs) of
    pipeline.decode_render_subsampled, and its key, the JAX package's
    _jitted_sub's static arguments."""
    from ..vardct.subsampled import _shifts, dense_planes

    fd = state.fd
    hs, vs = _shifts(fh) if not is444 else ([0, 0, 0], [0, 0, 0])
    inv_gs = state.quantizer.inv_global_scale
    qs = [state.qimg[c] for c in range(3)] if is444 \
        else dense_planes(state)
    dcs, scaled = [], []
    for c in range(3):
        nby, nbx = qs[c].shape[0] // 8, qs[c].shape[1] // 8
        dc = state.dc[c] if is444 else state.dc_sub[c][:nby, :nbx]
        dcs.append(np.asarray(dc, dtype=np.float32))
        qf = state.raw_quant_field[::1 << vs[c], ::1 << hs[c]][:nby, :nbx]
        scaled.append((inv_gs / qf).astype(np.float32))
    lf = fh.loop_filter
    h, w = fd.ysize_blocks * 8, fd.xsize_blocks * 8
    dm = np.stack([state.matrices.dequant_matrix(0, c).reshape(8, 8)
                   for c in range(3)]).astype(np.float32)
    shifts = tuple((int(hs[c]), int(vs[c])) for c in range(3))
    ts = (fd.ysize, fd.xsize) if (fd.ysize, fd.xsize) != (h, w) else None
    # render_tail reads the EPF sigma and SAD maps only when a pass runs
    epf = lf.epf_iters > 0
    args = ([q.astype(np.int32, copy=False) for q in qs], dcs, scaled, dm,
            gab_kernels(lf), block_sigma(state, lf) if epf else None,
            sad_mul(lf, h, w) if epf else None,
            tuple(f32(v) for v in lf.epf_channel_scale), shifts)
    kwargs = dict(epf_iters=int(lf.epf_iters), gab=bool(lf.gab),
                  pass0_sigma_scale=f32(lf.epf_pass0_sigma_scale),
                  pass2_sigma_scale=f32(lf.epf_pass2_sigma_scale),
                  to_u8=True, true_size=ts)
    return args, kwargs, (shifts, int(lf.epf_iters), bool(lf.gab), True, ts)


def make_device_render(fh, out: dict, device="cuda"):
    """render_fn for decode_vardct_frame: the frame's render on `device`
    (pipeline.decode_render_image: dequant_idct8 over every block, the
    other strategies' inverse transforms, the true-size mirror and
    render_tail; or the YCbCr render). Streams outside its scope render
    on the host, loudly: the reason is logged and recorded in
    out["path"] ("host:<reason>"); otherwise out["path"] is "device:u8"
    (final pixels in out["u8"]), "device:xyb" (XYB handed back for the
    host's post-render stages) or "device:u8-ycbcr". out["want_u8"]
    (default True) lets the u8 write stay on the device. Only those scope
    gates choose the host: a kernel that fails to build or launch
    raises."""
    import logging

    from ..io.frame_header import CT_XYB, CT_YCBCR
    from ..vardct.frame import render_groups

    dev = resolve_device(device)
    log = logging.getLogger("libjxl_tpu_torch.device")

    def host_fallback(state, reason):
        out["path"] = f"host:{reason}"
        log.warning("device render fell back to host: %s", reason)
        if getattr(state, "qimg", None) is not None \
                and not state.qblocks:
            _qblocks_from_qimg(state)
        render_groups(state)

    def render_device(state):
        fd = state.fd
        if getattr(state, "qblocks_sub", None) is not None \
                or list(fh.chroma_subsampling.channel_mode) != [0, 0, 0]:
            if _render_subsampled_device(state, fh, out, dev):
                state.restoration_done = True
                return
            out["path"] = "host:chroma-subsampled"
            log.warning("device render fell back to host: "
                        "chroma-subsampled stream")
            from ..vardct.subsampled import render_groups_sub

            render_groups_sub(state)
            return
        _dense_qimg(state)
        if fh.color_transform == CT_YCBCR:
            # 444 YCbCr (JPEG transcode without chroma subsampling)
            if _render_subsampled_device(state, fh, out, dev):
                state.restoration_done = True
                return
            host_fallback(state, "YCbCr 444 outside the lean device "
                          "program")
            return
        if fh.color_transform != CT_XYB or \
                getattr(state, "color_factor", 84) != 84 or \
                getattr(state, "base_x", 0.0) != 0.0 or \
                getattr(state, "base_b", 1.0) != 1.0:
            host_fallback(state, "non-XYB or custom color correlation")
            return
        h, w = fd.ysize_blocks * 8, fd.xsize_blocks * 8
        # with no post-render features the whole write stage (XYB->sRGB
        # u8) stays on the device and the host never touches pixel floats
        direct_u8 = (out.get("want_u8", True)
                     and state.patches is None
                     and state.splines is None and state.noise_lut is None
                     and fh.upsampling == 1
                     and fh.nonserialized_metadata.m.num_extra_channels
                     == 0
                     and fd.ysize == h and fd.xsize == w)
        staged = stage_image(state, fh, direct_u8)
        if staged is None:
            host_fallback(state, "unaligned/odd-size transform layout")
            return
        host = render_image(*staged, dev)
        if direct_u8:
            out["u8"] = host
            out["path"] = "device:u8"
            state.device_output_done = True
        else:
            state.xyb = host.astype(np.float64)
            out["path"] = "device:xyb"
        state.restoration_done = True

    return render_device


def decode(data: bytes, device="cuda"):
    """The port of decode_tpu: codestream.decode(data, device=device), the
    first frame with the device render. Returns (uint8 image, metadata)."""
    from . import codestream

    return codestream.decode(data, device=device)


# ------------------------------------------------------------------ encode
K_AC_QUANT = 0.79


def enc(rgb, dm_inv, dm, inv_global_scale, base_quant, x_dm_mult,
        b_dm_mult, qf_in=None, adaptive=True, cfl=True, gab=True,
        distance=None):
    """The device encode program (the JAX package's jitted `enc`):
    pipeline.encode_step on linear RGB f32[3, H, W] on its device, then the
    image-layout coefficients and the per-position zero counts the host
    entropy coder takes. Returns tensors (qimg i32[3, H, W], nz i32[3,
    64], dc f32[3, nby, nbx], qf, ytox, ytob, sharp i32)."""
    from ..vardct.heuristics import gaborish_inverse_kernel

    gab_kernel = gaborish_inverse_kernel(1.0).astype(np.float32) \
        if gab else None
    q, dc, qf, ytox, ytob, sharp = pipeline.encode_step(
        rgb, dm_inv, dm, gab_kernel, inv_global_scale, base_quant,
        x_dm_mult, b_dm_mult, adaptive=adaptive, cfl=cfl, qf_in=qf_in,
        distance=distance)
    qimg = pipeline.blocks_to_image(q)
    nz = (q == 0).sum(dim=(1, 2)).reshape(3, 64).to(torch.int32)
    return qimg, nz, dc, qf, ytox, ytob, sharp


def _encode_program(srgb, dm_inv, dm, inv_global_scale, base_quant,
                    x_dm_mult, b_dm_mult, adaptive, cfl, gab, distance):
    """The "enc" program: the JAX package's jitted srgb2lin, then its
    jitted enc, on sRGB f32[3, H, W]."""
    return enc(pipeline.srgb2lin(srgb), dm_inv, dm, inv_global_scale,
               base_quant, x_dm_mult, b_dm_mult, adaptive=adaptive, cfl=cfl,
               gab=gab, distance=distance)


def encode_lossy_tpu(image: np.ndarray, distance: float = 1.0,
                     adaptive_quant: bool = True, cfl: bool = True,
                     gaborish: bool = None, epf: int = None,
                     device="cuda") -> bytes:
    """Encode an sRGB uint8 (H, W, 3) image lossily with the encode step
    on `device` ("cuda" by default; a missing card raises; "cpu" runs the
    same torch ops on the CPU). Returns a bare JPEG XL codestream (DCT8
    strategy); the host codes the entropy. gaborish/epf: loop-filter
    overrides (None = encoder defaults). The device step is the "enc"
    program (srgb2lin and the encode step, its key the JAX package's
    static arguments (adaptive, cfl, gab, distance); the scalars, which
    its torch ops take by value, in the program's key too)."""
    from ..io.frame_header import CT_XYB, ENC_VARDCT, FT_REGULAR
    from ..io.headers import CodecMetadata, SizeHeader
    from ..vardct.ctx import QUANT_MAX
    from ..vardct.frame import (Quantizer, encode_vardct_frame,
                                initial_quant_dc)
    from ..vardct.quant_weights import DequantMatrices
    from .codestream import _calibrated_distance, write_codestream_header

    dev = resolve_device(device)
    public_distance = distance
    distance = _calibrated_distance(distance)
    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=2)
    h, w, _ = image.shape
    meta = CodecMetadata()
    meta.size = SizeHeader().set(w, h)
    writer = BitWriter()
    write_codestream_header(writer, meta)
    fh = FrameHeader(meta)
    fh.all_default = False
    fh.frame_type = FT_REGULAR
    fh.encoding = ENC_VARDCT
    fh.color_transform = CT_XYB
    fh.flags = 0  # adaptive DC smoothing on (see codestream.encode_lossy)
    fh.loop_filter.all_default = False
    fh.loop_filter.gab = True if gaborish is None else bool(gaborish)
    fh.loop_filter.epf_iters = 2 if epf is None else max(0, min(3, epf))

    fd = fh.frame_dimensions()
    # pad to a block multiple
    srgb = image.astype(np.float32) / 255.0
    srgb = np.moveaxis(srgb, -1, 0)
    srgb = np.pad(srgb, ((0, 0), (0, fd.ysize_padded - h),
                         (0, fd.xsize_padded - w)), mode="edge")

    # the quantizer setup on the host (encode_vardct_frame's): with the
    # adaptive field, which runs in the device step, the host fixes only
    # the global scale from the 0.39/d anchor (enc_heuristics.cc:1115)
    matrices = DequantMatrices()
    quantizer = Quantizer(matrices)
    quant_ac = K_AC_QUANT / distance
    quant_dc = initial_quant_dc(public_distance)
    if adaptive_quant:
        quant_median = 0.39 / distance
        quantizer.compute_global_scale_and_quant(quant_dc, quant_median)
        base_quant = 0  # unused on the adaptive path
    else:
        quantizer.compute_global_scale_and_quant(quant_dc, quant_ac)
        base_quant = max(1, min(QUANT_MAX, int(
            quant_ac * quantizer.inv_global_scale + 0.5)))
    dm = np.stack([matrices.dequant_matrix(0, c)
                   for c in range(3)]).astype(np.float32)
    dm_inv = np.stack([matrices.inv_matrix(0, c)
                       for c in range(3)]).astype(np.float32)
    x_dm_mult = (1 / 1.25) ** (fh.x_qm_scale - 2.0)
    b_dm_mult = (1 / 1.25) ** (fh.b_qm_scale - 2.0)

    scalars = (f32(quantizer.inv_global_scale), f32(base_quant),
               f32(x_dm_mult), f32(b_dm_mult))
    statics = dict(adaptive=adaptive_quant, cfl=cfl,
                   gab=bool(fh.loop_filter.gab),
                   distance=float(distance) if adaptive_quant else None)
    host = programs.run(
        "enc", tuple(statics.values()), _encode_program,
        np.ascontiguousarray(srgb), dm_inv, dm, *scalars, **statics,
        device=dev, readback=True)
    qimg, nz, dc, qf, ytox, ytob, sharp = host
    precomputed = {
        "quant_median": quant_median if adaptive_quant else quant_ac,
        "qimg": qimg, "nz": nz, "dc": dc, "qf": qf, "ytox_map": ytox,
        "ytob_map": ytob, "sharp": sharp}
    encode_vardct_frame(writer, None, fh, distance=distance,
                        precomputed=precomputed,
                        dc_distance=public_distance)
    return writer.get_bytes()
