"""Wrappers of the hand-written CUDA kernels, each beside its plain twin.

The counterpart of libjxl_tpu/ops/pallas_kernels.py. A wrapper given a
CPU tensor returns its plain twin from ops/pipeline.py. Given a CUDA
tensor it launches its kernel (built from ops/csrc by ops/build.py) on
the current stream, or raises; no path falls back. Each wrapper adds
one to its launch counter (base/device.py) where it launches, and
nowhere else. No launch reads host memory, so a program's capture
(ops/programs.py) can record any of them: K1's IDCT8 table is copied
into its constant memory once a device (_k1_tables), scalars go by
value.

dequant_idct8 (ops/csrc/dequant_idct8.cu) replaces TPU kernel K1,
  pallas_kernels.py dequant_cfl_pallas, and fuses the DC insert and
  IDCT8 that XLA did after it. Bound by device memory (~6-12 B read,
  12 B written a pixel); a thread owns one 8-coefficient block row
  (16-byte loads), an 8-lane group a block, both IDCT passes in
  registers with a shuffle transpose between them.
render_tail (ops/csrc/render_tail.cu) replaces TPU kernel K2,
  pallas_kernels.py epf_pass_pallas, and takes in the stages around it:
  Gaborish, the chained EPF passes and the XYB -> sRGB u8 write, one
  launch a batch. Bytes and operations bound it about equally; one CTA a
  16x64 output tile (build.RENDER_TILE) stages the tile and its halo in
  shared memory and runs the whole chain there. epf_pass is the same
  kernel in its one-pass configuration, counted under render_tail.
ans_decode (ops/csrc/ans_decode.cu) replaces TPU kernel K3,
  ans_kernel.py _make_kernel. Bound by latency: each lane's steps are a
  serial chain of dependent table loads; one thread per lane, one-warp
  CTAs of a few lanes of one image (LaneTensors.cta_first) holding that
  image's tables, the lanes' row files and cp.async-fed stream rings in
  shared memory. Plain twin: ops/ans_kernel.ans_decode_plain.

decode_pixels_hybrid and decode_render_blocks are the block-layout
routes, the counterparts of pallas_kernels.py decode_pixels_hybrid and
pipeline.py decode_render: the coefficients i32[..., 3, nby, nbx, 8, 8]
become one contiguous image-layout copy, which one dequant_idct8 launch
reads; decode_render_blocks then launches render_tail once. On CUDA
each is a program, "dec" and "dec_full" (the JAX package's jitted dec
and dec_full). Their plain twins are pipeline.decode_pixels and
pipeline.decode_render.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..base.device import launch_counter
from . import pipeline
from .ans_kernel import NZ_WIDTH, ZD_WIDTH, LaneTensors, ans_decode_plain
from . import programs
from .build import load as load_kernels
from .staging import UNEVEN_SIGMA, block_values, per_block

DEQUANT_IDCT8_LAUNCHES = launch_counter("dequant_idct8")
RENDER_TAIL_LAUNCHES = launch_counter("render_tail")
ANS_DECODE_LAUNCHES = launch_counter("ans_decode")

# (neighbours, SAD pattern) -> the EPF pass of that geometry
_EPF_GEOMETRY = {geometry: p for p, geometry in pipeline.EPF_GEOMETRY.items()}


def dequant_cfl(q_img, scale_img, dm_img, xcc_img, bcc_img):
    """K1's exact contract (pallas_kernels.py dequant_cfl_pallas) in
    plain torch: q i32[3, H, W]; scale, xcc, bcc f32[H, W] and dm f32[3,
    H, W] prebroadcast. Returns the dequantized coefficients f32[3, H,
    W]. The main path runs the fused dequant_idct8 instead."""
    dq_y = pipeline.adjust_quant_bias(q_img[1], 1) * dm_img[1] * scale_img
    dq_x = pipeline.adjust_quant_bias(q_img[0], 0) * dm_img[0] * scale_img \
        + xcc_img * dq_y
    dq_b = pipeline.adjust_quant_bias(q_img[2], 2) * dm_img[2] * scale_img \
        + bcc_img * dq_y
    return torch.stack([dq_x, dq_y, dq_b])


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _check_cuda(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    _require(t.device == device, f"{name}: on {t.device}, not {device}")
    _require(t.dtype == dtype, f"{name}: dtype {t.dtype}, not {dtype}")
    _require(tuple(t.shape) == tuple(shape),
             f"{name}: shape {tuple(t.shape)}, not {tuple(shape)}")
    _require(t.is_contiguous(), f"{name}: not contiguous")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


_K1_TABLES: set = set()
_K1_LOCK = threading.Lock()


def _k1_tables(device: torch.device) -> None:
    """dequant_idct8.cu's IDCT8 table in its constant memory on `device`,
    copied once a device, at the first launch there (an eager call: a
    program's capture replays a launch that came before it)."""
    if device.index in _K1_TABLES:
        return
    with _K1_LOCK:
        if device.index not in _K1_TABLES:
            _launch("dequant_idct8 tables",
                    load_kernels().jxl_dequant_idct8_tables(
                        pipeline._consts()["inv8"].ctypes.data,
                        device.index))
            _K1_TABLES.add(device.index)


def _scales(inv_global_scale, device) -> torch.Tensor:
    """inv_global_scale (a float, one an image, or a tensor) as f32[n] on
    `device`; a float is written by a fill kernel, not uploaded."""
    if isinstance(inv_global_scale, torch.Tensor):
        return inv_global_scale.to(device=device,
                                   dtype=torch.float32).reshape(-1)
    if np.ndim(inv_global_scale) == 0:
        return torch.full((1,), float(inv_global_scale),
                          dtype=torch.float32, device=device)
    return torch.as_tensor(inv_global_scale, dtype=torch.float32,
                           device=device).reshape(-1)


def dequant_idct8(qimg, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
                  x_dm_mult, b_dm_mult):
    """Dequant + AdjustQuantBias + CfL + DC insert + IDCT8.

    Contract of pipeline.decode_xyb_image (its plain twin). On CUDA:
    qimg int16 or int32 [B, 3, H, W] (or [3, H, W]) with H, W multiples
    of 8, qf i32, dc f32, ytox/ytob_map i32, dm f32[3, 8, 8], all
    contiguous on qimg's device; inv_global_scale f32 per image."""
    if qimg.device.type == "cpu":
        return pipeline.decode_xyb_image(qimg, qf, dc, ytox_map, ytob_map,
                                         dm, inv_global_scale, x_dm_mult,
                                         b_dm_mult)
    dev = qimg.device
    _require(dev.type == "cuda", f"dequant_idct8: device {dev}")
    single = qimg.dim() == 3
    igs = _scales(inv_global_scale, dev)
    if single:
        qimg, qf, dc, ytox_map, ytob_map = (
            t.unsqueeze(0) for t in (qimg, qf, dc, ytox_map, ytob_map))
    _require(qimg.dim() == 4 and qimg.shape[1] == 3,
             f"dequant_idct8: qimg shape {tuple(qimg.shape)}")
    bsz, _, h, w = qimg.shape
    _require(h % 8 == 0 and w % 8 == 0 and h > 0 and w > 0,
             f"dequant_idct8: {h}x{w} is not a multiple of 8")
    _require(qimg.dtype in (torch.int16, torch.int32),
             f"dequant_idct8: qimg dtype {qimg.dtype}")
    _require(qimg.is_contiguous(), "dequant_idct8: qimg not contiguous")
    nby, nbx = h // 8, w // 8
    nty, ntx = ytox_map.shape[-2:]
    tile = pipeline.COLOR_TILE_BLOCKS
    _require(nty * tile >= nby and ntx * tile >= nbx,
             f"dequant_idct8: CfL map {nty}x{ntx} too small")
    _check_cuda("qf", qf, torch.int32, (bsz, nby, nbx), dev)
    _check_cuda("dc", dc, torch.float32, (bsz, 3, nby, nbx), dev)
    _check_cuda("ytox_map", ytox_map, torch.int32, (bsz, nty, ntx), dev)
    _check_cuda("ytob_map", ytob_map, torch.int32, (bsz, nty, ntx), dev)
    _check_cuda("dm", dm, torch.float32, (3, 8, 8), dev)
    _check_cuda("inv_global_scale", igs, torch.float32, (bsz,), dev)
    _require(qimg.data_ptr() % 16 == 0 and dm.data_ptr() % 16 == 0,
             "dequant_idct8: qimg and dm are not 16-byte aligned")
    out = torch.empty((bsz, 3, h, w), dtype=torch.float32, device=dev)
    _k1_tables(dev)
    qb = [float(v) for v in pipeline._consts()["qbias"]]
    _launch("dequant_idct8", load_kernels().jxl_dequant_idct8(
        qimg.data_ptr(), int(qimg.dtype == torch.int16), qf.data_ptr(),
        dc.data_ptr(), ytox_map.data_ptr(), ytob_map.data_ptr(),
        dm.data_ptr(), igs.data_ptr(), *qb, float(x_dm_mult),
        float(b_dm_mult), bsz, h, w, nty, ntx, out.data_ptr(), _stream(dev),
        dev.index))
    DEQUANT_IDCT8_LAUNCHES.add()
    return out[0] if single else out


def _check_blocks(name, qcoeffs) -> None:
    _require(qcoeffs.dim() >= 5 and qcoeffs.shape[-5] == 3
             and tuple(qcoeffs.shape[-2:]) == (8, 8),
             f"{name}: qcoeffs shape {tuple(qcoeffs.shape)}, not block "
             "layout [..., 3, nby, nbx, 8, 8]")


def _image_args(qcoeffs, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
                x_dm_mult, b_dm_mult):
    """dequant_idct8's arguments for block-layout coefficients: one
    contiguous image-layout copy of them, the global scale as one f32 an
    image."""
    igs = _scales(inv_global_scale, qcoeffs.device)
    return (pipeline.blocks_to_image(qcoeffs).contiguous(), qf, dc, ytox_map,
            ytob_map, dm, igs.expand(qf[..., 0, 0].numel()).contiguous(),
            x_dm_mult, b_dm_mult)


def decode_pixels_hybrid(qcoeffs, qf, dc, ytox_map, ytob_map, dm,
                         inv_global_scale, x_dm_mult=1.0, b_dm_mult=1.0,
                         color_factor=pipeline.COLOR_FACTOR,
                         base_x=pipeline.BASE_X, base_b=pipeline.BASE_B):
    """The VarDCT decode of block-layout coefficients to linear RGB
    f32[..., 3, nby*8, nbx*8]: the contract of pipeline.decode_pixels
    (its plain twin, which CPU tensors get), for one image or a batch.

    On CUDA: one contiguous image-layout copy of qcoeffs, one
    dequant_idct8 launch (K1 with the DC insert and the IDCT8), then
    pipeline.xyb_to_rgb. The tensors follow dequant_idct8's contract, in
    the block layout; inv_global_scale is one f32 or one an image.
    color_factor, base_x and base_b must be the kernel's constants on
    either device (ValueError)."""
    _check_blocks("decode_pixels_hybrid", qcoeffs)
    _require((color_factor, base_x, base_b) == (
        pipeline.COLOR_FACTOR, pipeline.BASE_X, pipeline.BASE_B),
        f"decode_pixels_hybrid: dequant_idct8 fixes color_factor "
        f"{pipeline.COLOR_FACTOR}, base_x {pipeline.BASE_X} and base_b "
        f"{pipeline.BASE_B}; got {color_factor}, {base_x}, {base_b}")
    args = (qcoeffs, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
            x_dm_mult, b_dm_mult)
    if qcoeffs.device.type == "cpu":
        return pipeline.decode_pixels(*args)
    return programs.run(
        "dec", (), _pixels_program, qcoeffs, qf, dc, ytox_map, ytob_map, dm,
        _input_scale(inv_global_scale), x_dm_mult=float(x_dm_mult),
        b_dm_mult=float(b_dm_mult), device=qcoeffs.device)


def _input_scale(inv_global_scale):
    """inv_global_scale as a program input (a float becomes a 0-d f32
    array, so that the program takes it as data, as the JAX one does)."""
    if isinstance(inv_global_scale, torch.Tensor):
        return inv_global_scale
    return np.asarray(inv_global_scale, dtype=np.float32)


def _pixels_program(qcoeffs, qf, dc, ytox_map, ytob_map, dm,
                    inv_global_scale, x_dm_mult, b_dm_mult):
    """decode_pixels_hybrid's program (the JAX package's jitted `dec`,
    with the colour transform): the layout copy, K1, xyb_to_rgb."""
    return pipeline.xyb_to_rgb(dequant_idct8(*_image_args(
        qcoeffs, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
        x_dm_mult, b_dm_mult)))


def decode_render_blocks(qcoeffs, qf, dc, ytox_map, ytob_map, dm,
                         inv_global_scale, x_dm_mult, b_dm_mult, gab_kernels,
                         inv_sigma_px, sad_mul, channel_scale, epf_iters,
                         to_rgb=True, pass0_sigma_scale=0.9,
                         pass2_sigma_scale=6.5):
    """The full decode of block-layout coefficients: Gaborish (unless
    gab_kernels is None) and the EPF passes of epf_iters on the XYB, then
    linear RGB (to_rgb) or XYB, f32[..., 3, H, W]. The contract of
    pipeline.decode_render (its plain twin, which CPU tensors get).

    On CUDA: pipeline.decode_render_image of one contiguous image-layout
    copy of qcoeffs (one dequant_idct8 launch, one render_tail launch
    with XYB out, pipeline.xyb_to_rgb when to_rgb), or, where gab_kernels
    is None and epf_iters is 0, the dequant_idct8 launch alone.
    gab_kernels f32[3, 3, 3] and sad_mul f32[H, W] on the coefficients'
    device. render_tail reads sigma per 8x8 block, so with EPF an
    inv_sigma_px f32[..., H, W] that is not constant on every block raises
    ValueError on either device."""
    _require(epf_iters in pipeline.EPF_CHAINS,
             f"decode_render_blocks: epf_iters {epf_iters}")
    _check_blocks("decode_render_blocks", qcoeffs)
    args = (qcoeffs, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
            x_dm_mult, b_dm_mult)
    if qcoeffs.device.type == "cpu":
        if epf_iters:
            per_block(inv_sigma_px, "decode_render_blocks")
        return pipeline.decode_render(
            *args, gab_kernels, inv_sigma_px, sad_mul, channel_scale,
            epf_iters, to_rgb, pass0_sigma_scale, pass2_sigma_scale)
    out, uneven = programs.run(
        "dec_full", (epf_iters,), _render_blocks_program, qcoeffs, qf, dc,
        ytox_map, ytob_map, dm, _input_scale(inv_global_scale), gab_kernels,
        inv_sigma_px if epf_iters else None, sad_mul,
        x_dm_mult=float(x_dm_mult), b_dm_mult=float(b_dm_mult),
        channel_scale=tuple(float(c) for c in channel_scale),
        epf_iters=int(epf_iters), to_rgb=bool(to_rgb),
        pass0_sigma_scale=float(pass0_sigma_scale),
        pass2_sigma_scale=float(pass2_sigma_scale), device=qcoeffs.device)
    if bool(uneven):
        raise ValueError(UNEVEN_SIGMA.format("decode_render_blocks"))
    return out


def _render_blocks_program(qcoeffs, qf, dc, ytox_map, ytob_map, dm,
                           inv_global_scale, gab_kernels, inv_sigma_px,
                           sad_mul, x_dm_mult, b_dm_mult, channel_scale,
                           epf_iters, to_rgb, pass0_sigma_scale,
                           pass2_sigma_scale):
    """decode_render_blocks' program (the JAX package's jitted
    `dec_full`): the layout copy, K1, then K2 unless no filter runs.
    Returns (the image, a device flag set where inv_sigma_px is not
    constant on an 8x8 block), the flag read after the call."""
    image_args = _image_args(qcoeffs, qf, dc, ytox_map, ytob_map, dm,
                             inv_global_scale, x_dm_mult, b_dm_mult)
    uneven = torch.zeros((), dtype=torch.bool, device=qcoeffs.device)
    if gab_kernels is None and not epf_iters:
        xyb = dequant_idct8(*image_args)
        return (pipeline.xyb_to_rgb(xyb) if to_rgb else xyb), uneven
    sigma = None
    if epf_iters:
        sigma, uneven = block_values(inv_sigma_px)
        sigma = sigma.contiguous()
    return pipeline.decode_render_image(
        *image_args, gab_kernels, sigma, sad_mul, channel_scale, epf_iters,
        to_rgb, pass0_sigma_scale, pass2_sigma_scale), uneven


def _launch_tail(name, xyb, gab_kernels, inv_sigma, sad_mul,
                 channel_scale, passes, sigma_scales, out):
    """render_tail.cu's kernel for Gaborish (gab_kernels not None), the
    EPF `passes` (consecutive, in order) and `out` ("xyb" or "u8srgb") on
    a CUDA batch; one launch, counted under render_tail."""
    dev = xyb.device
    _require(dev.type == "cuda", f"{name}: device {dev}")
    single = xyb.dim() == 3
    if single:
        xyb = xyb.unsqueeze(0)
        if passes:
            inv_sigma = inv_sigma.unsqueeze(0)
    _require(xyb.dim() == 4 and xyb.shape[1] == 3,
             f"{name}: xyb shape {tuple(xyb.shape)}")
    bsz, _, h, w = xyb.shape
    halo = (pipeline.GABORISH_RADIUS if gab_kernels is not None else 0) \
        + sum(pipeline.epf_radius(p) for p in passes)
    _require(h >= max(halo, 1) and w >= max(halo, 1),
             f"{name}: {h}x{w} is below the halo {halo}")
    _check_cuda("xyb", xyb, torch.float32, (bsz, 3, h, w), dev)
    if passes:
        _check_cuda("inv_sigma", inv_sigma, torch.float32,
                    (bsz, -(-h // 8), -(-w // 8)), dev)
        _check_cuda("sad_mul", sad_mul, torch.float32, (h, w), dev)
    if gab_kernels is not None:
        _check_cuda("gab_kernels", gab_kernels, torch.float32, (3, 3, 3),
                    dev)
    cs = np.asarray([float(c) for c in channel_scale], dtype=np.float32)
    _require(cs.shape == (3,), f"{name}: channel_scale needs 3 values")
    scales = np.asarray([sigma_scales.get(p, 1.0) for p in range(3)],
                        dtype=np.float32)
    if out == "u8srgb":
        res = torch.empty((bsz, h, w, 3), dtype=torch.uint8, device=dev)
    else:
        res = torch.empty_like(xyb)
    k = pipeline._consts()
    _launch(name, load_kernels().jxl_render_tail(
        xyb.data_ptr(), res.data_ptr(),
        inv_sigma.data_ptr() if passes else None,
        sad_mul.data_ptr() if passes else None,
        gab_kernels.data_ptr() if gab_kernels is not None else None,
        passes[0] if passes else -1, passes[-1] if passes else -1,
        int(out == "u8srgb"), cs.ctypes.data, scales.ctypes.data,
        k["opsin_inv"].ctypes.data, float(k["cbrt_bias"]), float(k["bias"]),
        bsz, h, w, _stream(dev), dev.index))
    RENDER_TAIL_LAUNCHES.add()
    return res[0] if single else res


def render_tail(xyb, gab_kernels, inv_sigma, sad_mul, channel_scale,
                epf_iters, pass0_sigma_scale=0.9, pass2_sigma_scale=6.5,
                out="xyb"):
    """Gaborish (unless gab_kernels is None) -> the EPF passes of
    epf_iters -> out: "xyb" f32[..., 3, H, W] or "u8srgb" sRGB u8[..., H,
    W, 3].

    Plain twin: pipeline.render_tail_plain. On CUDA: xyb f32[B, 3, H, W]
    (or [3, H, W]) with H, W at least the chain's halo (the stages' summed
    radii, 4 for Gaborish + 2 passes, 7 at epf_iters 3); gab_kernels f32[3,
    3, 3], inv_sigma f32[B, ceil(H/8), ceil(W/8)] per block and sad_mul
    f32[H, W], all contiguous on xyb's device; the result is a new
    tensor."""
    _require(out in ("xyb", "u8srgb"), f"render_tail: out {out!r}")
    _require(epf_iters in pipeline.EPF_CHAINS,
             f"render_tail: epf_iters {epf_iters}")
    if xyb.device.type == "cpu":
        return pipeline.render_tail_plain(
            xyb, gab_kernels, inv_sigma, sad_mul, channel_scale, epf_iters,
            pass0_sigma_scale, pass2_sigma_scale, out)
    return _launch_tail(
        "render_tail", xyb, gab_kernels, inv_sigma, sad_mul, channel_scale,
        pipeline.EPF_CHAINS[epf_iters], pipeline._sigma_scales(
            pass0_sigma_scale, pass2_sigma_scale), out)


def epf_pass(xyb, inv_sigma, sad_mul, channel_scale, neighbors,
             sad_pattern, sigma_scale):
    """One EPF pass. inv_sigma is per block, f32[..., ceil(H/8),
    ceil(W/8)]; sad_mul f32[H, W] is shared by the batch.

    Plain twin: pipeline._epf_pass on the per-pixel expansion of
    inv_sigma. On CUDA: render_tail's kernel with this pass alone (no
    Gaborish, XYB out), counted under render_tail; xyb f32[B, 3, H, W] (or
    [3, H, W]) with H, W at least the pass's radius, contiguous on one
    device; the result is a new tensor."""
    key = (tuple(map(tuple, neighbors)),
           tuple(map(tuple, sad_pattern)) if sad_pattern else None)
    geometry = _EPF_GEOMETRY.get(key)
    _require(geometry is not None,
             "epf_pass: not one of the three stage_epf.cc pass geometries")
    if xyb.device.type == "cpu":
        h, w = xyb.shape[-2:]
        isp = pipeline._repeat2(inv_sigma, 8)[..., :h, :w]
        return pipeline._epf_pass(xyb, isp, sad_mul, channel_scale,
                                  neighbors, sad_pattern, sigma_scale)
    return _launch_tail("epf_pass", xyb, None, inv_sigma, sad_mul,
                        channel_scale, (geometry,),
                        {geometry: float(sigma_scale)}, "xyb")


def check_lanes(kernel: str, lt: LaneTensors) -> tuple[int, int, int]:
    """Raise unless every tensor of `lt` lies on one CUDA device,
    contiguous, with LanePlan.to's dtypes and shapes, and flat_hw 16-byte
    aligned (the stream ring's cp.async); returns (lanes, alias words an
    image, CTAs)."""
    dev = lt.flat_hw.device
    _require(dev.type == "cuda", f"{kernel}: device {dev}")
    L = lt.lane_off.numel()
    _require(0 < L, f"{kernel}: no lanes")
    _require(lt.a1.dim() == 2, f"{kernel}: a1 shape {tuple(lt.a1.shape)}")
    bsz, alias_words = lt.a1.shape
    _require(lt.flat_hw.dim() == 1 and lt.flat_hw.numel() > 0,
             f"{kernel}: flat_hw must be a non-empty vector")
    _require(lt.flat_hw.data_ptr() % 16 == 0,
             f"{kernel}: flat_hw is not 16-byte aligned (cp.async)")
    _require(lt.cta_first.dim() == 1 and lt.cta_first.numel() >= 2,
             f"{kernel}: cta_first shape {tuple(lt.cta_first.shape)}")
    n_cta = lt.cta_first.numel() - 1
    _require(4 <= lt.las <= 11, f"{kernel}: las {lt.las}")
    _require(0 < lt.t_alloc and lt.t_alloc * L < 2 ** 31,
             f"{kernel}: t_alloc {lt.t_alloc}")
    for name, dtype, shape in (
            ("flat_hw", torch.int16, lt.flat_hw.shape),
            ("lane_off", torch.int64, (L,)),
            ("n_chains", torch.int32, (L,)),
            ("bw", torch.int32, (L,)),
            ("lane_img", torch.int32, (L,)),
            ("a1", torch.int32, (bsz, alias_words)),
            ("a2", torch.int32, (bsz, alias_words)),
            ("nzclu", torch.uint8, (bsz, NZ_WIDTH)),
            ("zdclu", torch.uint8, (bsz, ZD_WIDTH)),
            ("kz", torch.int32, (128,)),
            ("cta_first", torch.int32, (n_cta + 1,))):
        _check_cuda(name, getattr(lt, name), dtype, shape, dev)
    return L, alias_words, n_cta


def ans_decode(lt: LaneTensors):
    """rANS decode of every lane's DCT8 AC tokens into a step tape.

    Returns (tape i32[t_alloc, L], ok bool[L], steps i32[L]), the contract
    of ans_kernel.ans_decode_plain (its plain twin, which a CPU LaneTensors
    gets). On CUDA every tensor of `lt` lies on one device, contiguous,
    with LanePlan.to's dtypes and shapes."""
    dev = lt.flat_hw.device
    if dev.type == "cpu":
        return ans_decode_plain(lt)
    L, alias_words, n_cta = check_lanes("ans_decode", lt)
    tape = torch.zeros((lt.t_alloc, L), dtype=torch.int32, device=dev)
    ok = torch.empty(L, dtype=torch.bool, device=dev)
    steps = torch.empty(L, dtype=torch.int32, device=dev)
    _launch("ans_decode", load_kernels().jxl_ans_decode(
        lt.flat_hw.data_ptr(), lt.flat_hw.numel(), lt.lane_off.data_ptr(),
        lt.n_chains.data_ptr(), lt.bw.data_ptr(), lt.lane_img.data_ptr(),
        lt.a1.data_ptr(), lt.a2.data_ptr(), lt.nzclu.data_ptr(),
        lt.zdclu.data_ptr(), lt.kz.data_ptr(), alias_words, lt.las, L,
        lt.t_alloc, lt.cta_first.data_ptr(), n_cta, tape.data_ptr(),
        ok.data_ptr(), steps.data_ptr(), _stream(dev), dev.index))
    ANS_DECODE_LAUNCHES.add()
    return tape, ok, steps
