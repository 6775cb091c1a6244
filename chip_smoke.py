#!/usr/bin/env python3
"""GPU smoke run of libjxl_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py
    python3 chip_smoke.py --sharded   # the multi-device phase alone

Needs one CUDA card, nvcc (on PATH or in CUDA_HOME, default
/usr/local/cuda) and a C compiler; no network, no JAX, and nothing of the
JAX package libjxl_tpu: the port carries its own host layers. It

1. builds the port's native host library (libjxl_tpu_torch/native) and
   its CUDA kernels from libjxl_tpu_torch/ops/csrc;
2. encodes distinct streams with the port's host encoder (a process
   pool): 32 photo-like 2048x2048 at d1/e3 with the encoder's default EPF
   (2 passes), 4 at 2048x2048 with epf=3 (the 12-neighbour pass), 2 at
   1021x765 (the true-size mirror); for the single-image path 4 at
   2048x2048 d1/e5 (dense size passes and 8x8 special tiles), 2 at
   1021x765 e5, one 1024x1024 e5 and a 2048x2048 4:2:0 YCbCr stream
   with Gaborish and 2 EPF passes; each but the YCbCr one is also decoded
   by the port's host decode, the reference; and
   two 512x512 d4 streams (tests/test_ans_kernel.py's generator);
3. holds dequant_idct8 (int16 and int32) and render_tail (the default
   chain and epf=3, XYB and u8 out) against their plain torch twins on the
   card, on the first 16-stream batch's staged inputs, and each EPF pass
   geometry alone (epf_pass, render_tail's kernel in its one-pass
   configuration) against _epf_pass; times each beside its twin and its
   bound, and splits the render (dequant_idct8, the true-size mirror,
   render_tail) by CUDA events on that batch and on the 1021x765 set;
4. holds ans_decode against its twin on the two 512x512 streams (tape,
   ok and steps exactly equal), then runs it at full width on the first
   16-stream batch (1024 lanes): with the placement it must reproduce the
   host entropy decode's coefficients of all 16 streams exactly; prints
   its time, ns a step and share of its bound beside its first port's
   34.868 ms;
5. drives the serving decode: decode_pipelined over the 32 streams
   (batch 16) with the launch counters reset just before, then
   decode_batch per batch of 16 and on the epf=3 and 1021x765 sets;
6. drives the device-entropy decode: decode_batch_entropy on both
   16-stream batches, with the counters reset just before, checks that
   the two batches (other images of one geometry) shared one program,
   which the second captured and replayed, and times the program body's
   stages on one batch;
7. checks every image against the host decode (at most 1 u8 step), the
   pipelined output against the batched and the device-entropy outputs
   (exactly), and the launch counts (dequant_idct8 and render_tail once
   a batch on every path, ans_decode once a device-entropy batch);
8. drives the single-image path, codestream.decode(..., device="cuda"),
   with the counters reset just before: the e5 frames, the YCbCr frame
   and the 23 conformance streams, each with the path record the JAX
   package's device decode gives (device:u8, device:xyb for the
   true-size crop, device:u8-ycbcr, host:<reason>), within 1 u8 step of
   the host decode (the corpus also within its oracle bounds; the
   filtered YCbCr frame of decode(..., device="cpu"), the same render on
   the plain twins), and
   dequant_idct8 + render_tail once an XYB frame, render_tail once a
   YCbCr frame; splits one 2048x2048 e5 frame's latency (host entropy +
   staging, then upload, K1, size passes, extra tiles, mirror,
   render_tail, readback by CUDA events), holds K1 and K2 against their
   twins on that frame, and prints MP/s beside the host decode; then
   codestream.decode_batch(..., device="cuda") on an interleaved list of
   16 x 2048x2048 e3, 2 x 1021x765 e3 and the 1024x1024 e5 stream: it
   buckets, each e3 bucket one batched render equal to the same batch's
   own, the e5 singleton through decode, order kept;
9. drives the device encode, counted (no hand kernel may launch):
   codestream.encode_lossy(..., device="cuda") of 4 photo-like 2048x2048
   images at d1/e3 beside the host encode of the same images (MP/s), the
   card's encode-step arrays against the CPU twin's on a 512x512 and a
   2048x2048 image (values that differ, bytes equal or not), the card's
   stream decoded on the card and by the host within 1 u8 step, and the
   split of one encode (srgb2lin and the encode step by CUDA events;
   host setup, upload, readback, host entropy coding by host clock);
   then the streaming encode of one 4096x4096 photo (four DC groups) with
   hosts=1 and hosts=2 (equal bytes, MP/s, peak device memory, the first
   DC group's step against the CPU twin); then the bounded-memory decode
   of the same photo encoded at e3 on the card:
   codestream.decode_rows(..., device="cuda") with the counters reset
   just before (u8 strips, dequant_idct8 and render_tail once a strip,
   within 1 u8 step of decode(..., device="cuda") and of the host strips,
   the per-strip split by CUDA events, MP/s and peak device memory beside
   the whole-image decode's), and an e5 stream, outside the strips'
   device scope, through the host strips with no launch;
10. drives the encoder heuristics on the card, counted:
   codestream.encode_lossy(..., device="cuda") of 2 photo-like 2048x2048
   images at d1/e5 (the AC-strategy tile costs; no launch) and one at e7
   (also the butteraugli refinement: render_tail once a round, 2 rounds),
   and one 1024x1024 at e7; each e5 image and the 1024x1024 one beside
   the host encode (device=None) of the same image (MP/s, bytes, size
   ratio, strategy blocks that differ); each card stream decoded on the
   card within 1 u8 step of the host decode; the split of one e5 and one
   e7 encode (tile costs, refinement by CUDA events, the rest by host
   clock); the first e5 search's tile costs on the card against the CPU
   twin for every size of the e7 ladder (relative error, CUDA-event ms
   beside the twin's and the host numpy's), and the search from either's
   costs (blocks that differ); butteraugli_diffmap_torch on the card
   against the CPU twin at 512x512, and at 2048x2048 its time, peak
   device memory and torch operations; render_tail against its twin on
   the e7 trial's own inputs; each device stage a program (tile_cost a
   tile size, trial, diffmap): the second e5 encode captures the tile
   sizes the first ran, the e7 encode's second round the trial and the
   diffmap, the e7 image encoded again replays every program and on the
   eager route (every call eager), bytes equal both ways, with what the
   programs hold beside the cache's memory bound;
11. drives the multi-device path (libjxl_tpu_torch/parallel) on a mesh
   of 4 entries, the cards in turn (on one card a virtual mesh of
   cuda:0, which it logs), each counted: tpu_codec.decode_batch_sharded
   of the first 16-stream batch (equal to decode_pipelined's, one
   dequant_idct8 and one render_tail a shard, host clock beside
   decode_batch's); one 8192x8192 d1/e3 photo encoded on the card,
   entropy-decoded on the host and rendered as 4 row bands by
   sharding.build_sharded_decode_stream against the whole-image render
   (equal; the gate is 1 step, under 1e-3 of the values), the whole
   render and the band program on a 1-entry and on the 4-entry mesh
   timed by CUDA events with their peak device memory, both kernels on
   the second band's own inputs against their twins; the 4096x4096
   streaming encode with the mesh (bytes equal to hosts=1's, no launch);
   build_sharded_decode_full and build_sharded_encode on a (batch 2, rows
   2) mesh at 2048x2048 against the unsharded forms on the card; each
   builder (a program a mesh entry and phase) and decode_batch_sharded
   ("batch" a card) called twice more, capture and replay, each bitwise
   its eager call with its launches, the band program also timed on the
   eager route, and the halo path (peer access between cards) logged;
   with --sharded this phase alone, on four real cards where the machine
   has them;
12. drives the user entry points on the card, each tool through its
   main(argv) in this process with the counters reset just before and read
   just after, on PPM files in a temporary directory: djxl on the four
   2048x2048 e5 streams (dequant_idct8 and render_tail once a frame,
   within 1 u8 step of the host decode, MP/s beside djxl --host); djxl
   --low_memory on the 4096x4096 photo at e3 (16 strips, each kernel
   once a strip, rows equal to decode_rows on the card); cjxl -e 3 (no
   launch) and -e 7 (render_tail once a refinement round) of a 2048x2048
   photo, bytes against codestream.encode_lossy called with cjxl's
   arguments; a 2048x2048 4:2:0 JPEG made by jpegli, recompressed by
   cjxl and given back byte for byte by djxl (in a worker process,
   beside the card work: host code), then rendered by djxl on the card
   (the YCbCr route: render_tail once) within 1 u8 step of the host
   decode, and the same for the corpus pair jpeg_recon.{jpg,jxl}; one
   benchmark row (--codec d1.0, 1024x1024: its host metrics take ~70 s at
   2048x2048), its decode on the card; Encoder(device) bytes against
   encode_lossy's; Decoder(device) on a 2048x2048 e5 stream fed in 4
   chunks (the per-section host route, no launch) and on a 2-frame
   animation whose second frame blends (the whole-stream route: one
   dequant_idct8 and one render_tail);
13. drives the conformance runner, the fuzz harness and the last host
   tools on the card, each counted: `conformance generate --device cuda`
   of a 2048x2048 d1/e5 photo, a 2048x2048 d2/e7 photo (render_tail once
   a refinement round) and a 256x256 lossless case, then `conformance
   check` of that corpus on the card (one dequant_idct8 and one
   render_tail a VarDCT case) and with --host (no launch), every case
   passing the runner's bounds both ways; tools/fuzz.run on the card for
   the decode and container targets (200 inputs each) and the encode
   target (100), seed 0: no finding, with the inputs during which a
   kernel launched counted (at least one); the first 16-stream batch
   through the kernel checks of step 3 again (a sticky CUDA error left by
   a fuzzed launch fails there); on a 2048x2048 e5 .jxl input
   decode_and_encode and the decode_oneshot example (within 1 u8 step of
   the host decode), cjxl (bytes equal to encode_lossy of the card's
   decode with cjxl's arguments), cjpegli and the encode_oneshot example;
   butteraugli_main and ssimulacra2_main of a 512x512 .jxl against its
   source; rd_measure of a 64x64 .jxl where the system libjxl is present;
14. drives the block-layout decode on the card, each route counted:
   entry.entry()'s step on one 256x256 group (one dequant_idct8) against
   its twin; the first 2048x2048 e3 stream's host-decoded coefficients
   reshaped to contiguous blocks, through kernels.decode_pixels_hybrid
   (one dequant_idct8; its XYB within K1_TOL of pipeline.decode_xyb) and
   kernels.decode_render_blocks (one dequant_idct8 and one render_tail,
   equal to pipeline.decode_render_image of the same image-layout
   inputs; both kernels on the route's own inputs against their twins),
   each timed by CUDA events beside the image-layout call, the layout
   copy alone and the twin on the card; sharding.build_sharded_decode on
   a (batch 2, rows 2) mesh of 4 entries at 2 x 2048x2048 with per-tile
   CfL maps (one dequant_idct8 a shard) against the unsharded route and a
   whole-image Gaborish (equal), and the dry run's block-layout step
   (parallel/dryrun.dryrun_codec_step) on that mesh;
15. runs each of the port's programs (libjxl_tpu_torch/ops/programs.py,
   the JAX package's jitted programs as cached CUDA graphs; every phase
   above runs through them) again on an input an earlier phase handed
   it (ProgramSpy): the first 16-stream batch, the 2048x2048 e5 frame,
   the 4:2:0 YCbCr frame, a 4096x4096 strip, a 2048x2048 e3 encode, the
   first streaming DC group's prep and step, entry()'s group, the block
   route, the device-entropy batch, each tile size of a 2048x2048
   search, the 2048x2048 e7 trial and diffmap, and a phase of every
   sharded builder, eager (cache cleared) against
   replay: bitwise equal, equal launches, each call and each body timed
   by CUDA events and the host clock, the capture's time, the memory the
   program holds and an eager call's peak;
16. holds every probe kernel (the TPU gather probes S1-S7,
   libjxl_tpu_torch/probes) against its twin, exactly, then drives the
   probes with the counters reset just before: every S1-S5 form timed
   at its TPU probe's step count (ns per lane-step, the marginal cost
   t(5n) - t(n) over 4n) beside its twin, S6's 560 no-op launches eager
   and from a CUDA graph, and S7's profile of the device-entropy stages
   on the first 16-stream batch (the stream-copy floor, ans_decode's
   cost a step and fixed cost, the tape fill, place's pieces).

It prints the phase seconds, a JSON line of the encode, streaming,
strip, heuristics, sharded, tools, conformance+fuzz, block-layout and
programs records, a JSON
line of the conformance+fuzz record alone, the rates (render-only, pipelined
end-to-end, host-entropy and device-entropy end-to-end MP/s, with the
device-entropy stages) with the card's name, a line a probe form and the
K3 split with the card's name and power limit, a JSON line of the kernels
(each with its bound: bytes at 3.35 TB/s or operations at 67 TFLOP/s,
whichever is larger), the card's nvidia-smi name and power limit, and
last {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; so does a machine without CUDA, and a run that imported JAX or
libjxl_tpu.
"""

import json
import os
import sys
import time

import numpy as np

BATCH = 16
SIZE = 2048
ODD_SIZE = (765, 1021)  # (height, width), not multiples of 8
E5_FRAMES = 4  # 2048^2 d1/e5 frames of the single-image path
ENCODE_FRAMES = 4  # 2048^2 d1/e3 photos of the device encode
BIG = 4096  # the streaming and strips photo: four 2048^2 DC groups
MIXED_E5 = 1024  # the side of the e5 singleton in the mixed decode_batch
U8_BOUND = 1  # u8 steps from the host decode (tests/test_decode_batch.py)
K1_TOL = dict(rtol=1e-5, atol=1e-5)
# each render's kernels, on every path and filter configuration
RENDER_LAUNCHES = {"dequant_idct8": 1, "render_tail": 1}
K2_TOL = dict(rtol=2e-4, atol=2e-5)  # sum order differs (test_pallas.py)
# An H100 SXM's peaks (NVIDIA's data sheet): device memory, and fp32
# outside the tensor cores, the rate integer operations are counted at too
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
# Operations a unit of work, counted from the plain twins' arithmetic:
# K1 a coefficient (AdjustQuantBias and dequant 6, two 8-tap IDCT passes
# 32); the render tail a pixel: Gaborish (3 channels x 9 multiply-adds),
# an EPF pass a neighbour (cross-difference 11, weight 3, accumulation 7,
# plus the SAD pattern's taps) and a pass a pixel (division and skip 4),
# the colour epilogue (XYB cubes 14, 3x3 matrix 15, sRGB curve and u8
# rounding 11); K3 a step (refill 6, contexts 25, alias entry and state
# 20, hybrid uint 20, bookkeeping 15, chain advance 10, tape 4); S7 a step.
K1_OPS = 38
GAB_OPS = 54
K2_OPS_NEIGHBOUR, K2_OPS_PIXEL = 21, 4
COLOUR_OPS = 40
K3_OPS_PER_STEP = 100
S7_OPS_PER_STEP = 6
K3_PREV_MS = 34.868  # ans_decode's first port on 16 x 2048^2 (PERF.md)


def tail_tol(epf_iters):
    """K2_TOL compounded over the default chain's filter stages: Gaborish
    and the EPF passes."""
    n = 1 + epf_iters
    return {k: v * n for k, v in K2_TOL.items()}


def make_image(h, w, seed):
    """Smooth photo-like content plus mild noise (the JAX bench's
    generator, generalised to h x w)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (120 + 60 * np.sin(xx * 0.003) + 50 * np.cos(yy * 0.002 + 1)
           + 20 * np.sin((xx + yy) * 0.01) + rng.normal(0, 5, (h, w)))
    rgb = np.stack([img, img * 0.9 + 10, img * 1.1 - 12], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def small_image(n, seed, noise=3.0):
    """tests/test_ans_kernel.py's generator: n x n, smooth plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    img = (128 + 50 * np.sin(xx * 0.013) + 40 * np.cos(yy * 0.009)
           + rng.normal(0, noise, (n, n)))
    rgb = np.stack([img, img * 0.92 + 8, img * 1.05 - 9], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def ycbcr_stream(h, w, seed):
    """A 4:2:0 YCbCr VarDCT stream of make_image (the layout of a JPEG
    transcode) with Gaborish and 2 EPF passes, so that render_tail filters
    the block-padded luma-size planes; built as tests/test_decode_path.py
    builds its subsampled stream, with the port's encoder."""
    from libjxl_tpu_torch.api.codestream import write_codestream_header
    from libjxl_tpu_torch.io.bits import BitWriter
    from libjxl_tpu_torch.io.frame_header import (
        CT_YCBCR, ENC_VARDCT, FLAG_SKIP_ADAPTIVE_DC_SMOOTHING, FT_REGULAR,
        FrameHeader)
    from libjxl_tpu_torch.io.headers import CodecMetadata, SizeHeader
    from libjxl_tpu_torch.vardct.frame import rgb_to_ycbcr
    from libjxl_tpu_torch.vardct.subsampled import encode_vardct_subsampled

    meta = CodecMetadata()
    meta.size = SizeHeader().set(w, h)
    meta.m.all_default = False
    meta.m.xyb_encoded = False
    writer = BitWriter()
    write_codestream_header(writer, meta)
    fh = FrameHeader(meta)
    fh.all_default = False
    fh.frame_type = FT_REGULAR
    fh.encoding = ENC_VARDCT
    fh.color_transform = CT_YCBCR
    fh.chroma_subsampling.channel_mode = [0, 1, 0]  # 4:2:0
    fh.flags = FLAG_SKIP_ADAPTIVE_DC_SMOOTHING
    fh.loop_filter.all_default = False
    fh.loop_filter.gab = True
    fh.loop_filter.epf_iters = 2
    ycbcr = rgb_to_ycbcr(np.moveaxis(
        make_image(h, w, seed).astype(np.float64) / 255, -1, 0))
    planes = []
    for c in range(3):
        fy = 1 << fh.chroma_subsampling.vshift(c)
        fx = 1 << fh.chroma_subsampling.hshift(c)
        h2, w2 = h // fy * fy, w // fx * fx
        planes.append(ycbcr[c][:h2, :w2].reshape(
            h2 // fy, fy, w2 // fx, fx).mean(axis=(1, 3)))
    encode_vardct_subsampled(writer, planes, fh, distance=1.0)
    return writer.get_bytes()


def blend_animation(frames, device):
    """A lossy animation whose second frame blends onto the first (kAdd
    from reference slot 1, where the first frame is saved): its frames
    are not independent, so api/decoder.Decoder decodes it whole through
    codestream.decode on its device. Written frame by frame as
    codestream.encode_animation writes its kReplace frames."""
    from libjxl_tpu_torch.api.codestream import write_codestream_header
    from libjxl_tpu_torch.io.bits import BitWriter
    from libjxl_tpu_torch.io.frame_header import (BLEND_ADD, CT_XYB,
                                                  ENC_VARDCT, FT_REGULAR,
                                                  FrameHeader)
    from libjxl_tpu_torch.io.headers import CodecMetadata, SizeHeader
    from libjxl_tpu_torch.ops.xyb import srgb_to_linear
    from libjxl_tpu_torch.vardct.frame import encode_vardct_frame

    h, w = frames[0].shape[:2]
    meta = CodecMetadata()
    meta.size = SizeHeader().set(w, h)
    meta.m.all_default = False
    meta.m.have_animation = True
    writer = BitWriter()
    write_codestream_header(writer, meta)
    for i, frame in enumerate(frames):
        fh = FrameHeader(meta)
        fh.all_default = False
        fh.frame_type = FT_REGULAR
        fh.encoding = ENC_VARDCT
        fh.color_transform = CT_XYB
        fh.flags = 0
        fh.is_last = i == len(frames) - 1
        fh.animation_frame.nonserialized_metadata = meta
        fh.animation_frame.duration = 1
        if i == 0:
            fh.save_as_reference = 1
        else:
            fh.blending_info.mode = BLEND_ADD
            fh.blending_info.source = 1
        fh.loop_filter.all_default = False
        fh.loop_filter.gab = True
        fh.loop_filter.epf_iters = 2
        rgb = np.moveaxis(srgb_to_linear(frame.astype(np.float64) / 255.0),
                          -1, 0)
        encode_vardct_frame(writer, rgb, fh, distance=1.0, device=device)
        writer.zero_pad_to_byte()
    return writer.get_bytes()


def encode_and_reference(job):
    """Pool worker: (h, w, seed, kind) -> (stream, host-decoded u8 RGB).
    kind None or 3: d1/e3 with that EPF setting; "e5": d1 at effort 5;
    "ycbcr": ycbcr_stream, with None for its reference (drive_single
    renders it on the CPU); "small": a 512x512 d4 stream of
    small_image."""
    from libjxl_tpu_torch.api import codestream

    h, w, seed, kind = job
    if kind == "small":
        stream = codestream.encode_lossy(small_image(h, seed), distance=4.0,
                                         effort=3, device=None)
    elif kind == "e5":
        stream = codestream.encode_lossy(make_image(h, w, seed),
                                         distance=1.0, effort=5, device=None)
    elif kind == "ycbcr":
        return ycbcr_stream(h, w, seed), None
    else:
        stream = codestream.encode_lossy(make_image(h, w, seed),
                                         distance=1.0, effort=3, epf=kind,
                                         device=None)
    ref = codestream.decode(stream, device=None)[0][:, :, :3]
    return stream, np.ascontiguousarray(ref)


def log(msg):
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over `reps` runs after one warm-up
    (CUDA events). The 16-image batch's inputs exceed the 50 MB L2; the
    512x512 streams' lane plan does not, so its K3 time is a warm one."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, ref):
    return float((got - ref).abs().max().item())


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes, ops, library_ms=None):
    """The record keys of a kernel's bound: the larger of its bytes over
    the device memory rate and its operations over the fp32 rate, in ms,
    and which of the two it is; library_ms, one PyTorch call's time for
    the same function where there is one."""
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / FP32_OPS_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": library_ms}


def tail_work(xyb, isg, sad_mul, gab, passes, out):
    """(bytes, operations) of a render_tail launch on the batch xyb: each
    input read once (the XYB, and sigma and the SAD map when a pass reads
    them), the output written once; the stages' arithmetic counted from
    the twin."""
    from libjxl_tpu_torch.ops.pipeline import EPF_GEOMETRY

    npx = xyb[:, 0].numel()
    nbytes = tensor_bytes(xyb) + (3 if out == "u8srgb" else 12) * npx
    if passes:
        nbytes += tensor_bytes(isg, sad_mul)
    if gab is not None:
        nbytes += tensor_bytes(gab)
    ops = GAB_OPS if gab is not None else 0
    for p in passes:
        neighbors, pattern = EPF_GEOMETRY[p]
        ops += len(neighbors) * (K2_OPS_NEIGHBOUR
                                 + (len(pattern) if pattern else 1)) \
            + K2_OPS_PIXEL
    if out == "u8srgb":
        ops += COLOUR_OPS
    return nbytes, ops * npx


def check_kernels(renderer, inputs, config):
    """Each kernel against its plain twin on the batch's staged inputs,
    timed beside it; returns the JSON records (launches filled in
    later)."""
    import torch

    from libjxl_tpu_torch.ops import kernels, pipeline

    qimg, qf, dc, ytox, ytob, igs, isg = inputs
    k1_args = (qf, dc, ytox, ytob, renderer.dm, igs, config.x_dm_mult,
               config.b_dm_mult)
    k1_err = 0.0
    for q in (qimg, qimg.to(torch.int32)):
        got = kernels.dequant_idct8(q, *k1_args)
        ref = pipeline.decode_xyb_image(q, *k1_args)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        check(torch.allclose(got, ref, **K1_TOL),
              f"dequant_idct8 ({q.dtype}) disagrees with decode_xyb_image: "
              f"max abs err {err}")
        log(f"check dequant_idct8 qimg {q.dtype}: max abs err {err}")
        k1_err = max(k1_err, err)
        del got, ref
    k1_ms = cuda_ms(lambda: kernels.dequant_idct8(qimg, *k1_args), 10)
    k1_plain = cuda_ms(lambda: pipeline.decode_xyb_image(qimg, *k1_args), 3)
    # inputs once, the f32 XYB planes written once
    k1_bound = bound(tensor_bytes(qimg, qf, dc, ytox, ytob, renderer.dm, igs)
                     + 4 * qimg.numel(), K1_OPS * qimg.numel())
    shape = tuple(qimg.shape)
    log(f"K1 dequant_idct8 at B={shape[0]}, {shape[2]}x{shape[3]}: "
        f"{k1_ms:.4f} ms (plain {k1_plain:.4f} ms; bound "
        f"{k1_bound['bound_ms']:.4f} ms, {k1_bound['bound_by']}, "
        f"{100 * k1_bound['bound_ms'] / k1_ms:.1f}% of it)")

    xyb = kernels.dequant_idct8(qimg, *k1_args)
    npx = xyb[:, 0].numel()
    gab = renderer.gab_kernels
    cs = config.channel_scale
    s0, s2 = config.pass0_sigma_scale, config.pass2_sigma_scale
    by_chain = {}
    for name, iters in (("default", config.epf_iters), ("epf3", 3)):
        args = (xyb, gab, isg, renderer.sad_mul, cs, iters, s0, s2)
        got = kernels.render_tail(*args, out="xyb")
        ref = pipeline.render_tail_plain(*args, out="xyb")
        torch.cuda.synchronize()
        tol = tail_tol(iters)
        err = max_err(got, ref)
        check(torch.allclose(got, ref, **tol),
              f"render_tail {name} (XYB) disagrees with render_tail_plain: "
              f"max abs err {err}")
        del got, ref
        got = kernels.render_tail(*args, out="u8srgb")
        ref = pipeline.render_tail_plain(*args, out="u8srgb")
        torch.cuda.synchronize()
        steps = int((got.int() - ref.int()).abs().max())
        differ = int((got != ref).any(dim=-1).sum())
        check(steps <= U8_BOUND, f"render_tail {name} (u8) is {steps} steps "
              f"from render_tail_plain")
        del got, ref
        ms = cuda_ms(lambda: kernels.render_tail(*args, out="u8srgb"), 10)
        plain = cuda_ms(
            lambda: pipeline.render_tail_plain(*args, out="u8srgb"), 3)
        rec = bound(*tail_work(xyb, isg, renderer.sad_mul, gab,
                               pipeline.EPF_CHAINS[iters], "u8srgb"))
        log(f"check render_tail {name} (Gaborish + epf_iters {iters}): XYB "
            f"max abs err {err} (rtol {tol['rtol']:g} / atol "
            f"{tol['atol']:g}); u8 at most {steps} step, {differ} of {npx} "
            f"pixels differ; {ms:.4f} ms vs plain {plain:.4f} ms; bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
            f"{100 * rec['bound_ms'] / ms:.1f}% of it)")
        by_chain[name] = {"epf_iters": iters, "ms": ms, "plain_ms": plain,
                          "max_abs_err": err, "u8_max_steps": steps,
                          "u8_pixels_differ": differ, **rec}

    # each pass geometry alone, on the Gaborish output, as the later
    # single-image render calls it
    xyb = pipeline.gaborish(xyb, gab)
    h, w = xyb.shape[-2:]
    isp_px = pipeline._repeat2(isg, 8)[..., :h, :w]
    scales = {0: s0, 1: 1.0, 2: s2}
    by_geometry = {}
    for p, (neigh, pattern) in pipeline.EPF_GEOMETRY.items():
        args = (renderer.sad_mul, cs, neigh, pattern, scales[p])
        got = kernels.epf_pass(xyb, isg, *args)
        ref = pipeline._epf_pass(xyb, isp_px, *args)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        check(torch.allclose(got, ref, **K2_TOL),
              f"epf_pass pass{p} disagrees with _epf_pass: max abs err {err}")
        del got, ref
        ms = cuda_ms(lambda: kernels.epf_pass(xyb, isg, *args), 10)
        plain = cuda_ms(lambda: pipeline._epf_pass(xyb, isp_px, *args), 3)
        rec = bound(*tail_work(xyb, isg, renderer.sad_mul, None, (p,),
                               "xyb"))
        log(f"check epf_pass pass{p}: max abs err {err}; {ms:.4f} ms vs "
            f"plain {plain:.4f} ms; bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
        by_geometry[f"pass{p}"] = {"ms": ms, "plain_ms": plain,
                                   "max_abs_err": err, **rec}
    del xyb, isp_px
    main = by_chain["default"]
    return [
        {"name": "dequant_idct8", "route": "cuda",
         "source": "libjxl_tpu_torch/ops/csrc/dequant_idct8.cu",
         "replaces": "libjxl_tpu/ops/pallas_kernels.py:60",
         "launches": 0, "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain, **k1_bound},
        # the main path's chain stands for the kernel; epf=3 and the
        # single passes beside it
        {"name": "render_tail", "route": "cuda",
         "source": "libjxl_tpu_torch/ops/csrc/render_tail.cu",
         "replaces": "libjxl_tpu/ops/pallas_kernels.py:168",
         "launches": 0,
         "max_abs_err": max(c["max_abs_err"] for c in by_chain.values()),
         "u8_max_steps": main["u8_max_steps"],
         **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
         "by_chain": by_chain, "by_geometry": by_geometry},
    ]


def stage_ms(run, reps=5):
    """The device milliseconds of each stage of run(mark), by CUDA events,
    mean of `reps` runs after one warm-up, and run's last result. run
    calls mark(stage, tensor) as each stage's work is queued (the hook of
    pipeline.decode_render_image); a stage is timed from the previous
    mark, or from the run's start."""
    import torch

    total = {}
    with torch.inference_mode():
        for rep in range(reps + 1):
            events = [(None, torch.cuda.Event(enable_timing=True))]
            events[0][1].record()

            def mark(stage, _tensor=None, events=events):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append((stage, ev))
            out = run(mark)
            torch.cuda.synchronize()
            if rep:
                for (_, a), (stage, b) in zip(events, events[1:]):
                    total[stage] = total.get(stage, 0.0) \
                        + a.elapsed_time(b) / reps
    return total, out


def render_split(renderer, inputs, reps=5):
    """BatchRenderer.forward's stages (pipeline.RENDER_STAGES: the kernels,
    the true-size mirror between them, and the strategy stages, empty on
    an all-DCT8 batch), each timed by CUDA events over `reps` renders
    after one warm-up: {stage: mean ms}."""
    return stage_ms(lambda mark: renderer(*inputs, mark=mark), reps)[0]


def check_ans_decode(small_streams, batch, host_qimg, dev, card):
    """ans_decode against its twin on the small streams, then at full
    width on `batch`, whose placed coefficients must equal the host
    entropy decode's `host_qimg`. Logs its time, ns a step and share of
    its bound on `batch` beside its first port's time; returns its JSON
    record."""
    import torch

    from libjxl_tpu_torch.api import tpu_codec
    from libjxl_tpu_torch.ops import ans_kernel, kernels

    _, _, lp = tpu_codec.prepare_batch_entropy(small_streams)
    lt = lp.to(dev)
    tape, ok, steps = kernels.ans_decode(lt)
    torch.cuda.synchronize()
    t = time.perf_counter()
    rtape, rok, rsteps = ans_kernel.ans_decode_plain(lp.to("cpu"))
    plain_ms = (time.perf_counter() - t) * 1e3
    check(bool(rok.all()), "the twin flags a lane of the small streams")
    tape_err = int((tape.cpu().long() - rtape.long()).abs().max())
    check(tape_err == 0, f"ans_decode tape differs from the twin's: max "
          f"abs err {tape_err}")
    check(torch.equal(ok.cpu(), rok) and torch.equal(steps.cpu(), rsteps),
          "ans_decode ok/steps differ from the twin's")
    small_ms = cuda_ms(lambda: kernels.ans_decode(lt), 5)
    small = f"{len(small_streams)} x 512^2 d4, {lp.n_lanes} lanes, " \
        f"{int(rsteps.max())} steps"
    log(f"check ans_decode on {small}: tape, ok, steps equal to the twin; "
        f"{small_ms:.3f} ms vs plain {plain_ms:.1f} ms (host clock)")
    del tape, ok, steps, rtape

    t = time.perf_counter()
    _, _, lp = tpu_codec.prepare_batch_entropy(batch)
    t_plan = time.perf_counter() - t
    lt = lp.to(dev)
    torch.cuda.reset_peak_memory_stats()
    tape, ok, steps = kernels.ans_decode(lt)
    check(bool(ok.all()), "ans_decode flags lanes of the full batch")
    tape = tape[:int(steps.max())]
    qimg = ans_kernel.place(tape, lp)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ref = torch.from_numpy(host_qimg).to(dev, torch.int32)
    check(qimg.shape == ref.shape, f"placed qimg {tuple(qimg.shape)} != "
          f"host {tuple(ref.shape)}")
    qimg_err = int((qimg - ref).abs().max())
    check(qimg_err == 0, f"ans_decode + place differ from the host qimg: "
          f"max abs err {qimg_err}")
    del qimg, ref
    k3_ms = cuda_ms(lambda: kernels.ans_decode(lt), 3)
    # on the device-entropy program's padded inputs (program_plan)
    pt = ans_kernel.program_plan(lp).to(dev)
    k3_padded_ms = cuda_ms(lambda: kernels.ans_decode(pt), 3)
    del pt
    place_ms = cuda_ms(lambda: ans_kernel.place(tape, lp), 3)
    most, done = int(steps.max()), int(steps.sum())
    # the streams and tables read once; the tape words the lanes write
    # (their steps, not t_alloc), ok and steps
    k3_bound = bound(
        tensor_bytes(lt.flat_hw, lt.lane_off, lt.n_chains, lt.bw,
                     lt.lane_img, lt.a1, lt.a2, lt.nzclu, lt.zdclu, lt.kz,
                     lt.cta_first) + 4 * done + 5 * lp.n_lanes,
        K3_OPS_PER_STEP * done)
    ns_per_step = k3_ms * 1e6 / most
    full = f"{len(batch)} x {SIZE}^2 d1/e3, {lp.n_lanes} lanes, " \
        f"{most} steps"
    log(f"check ans_decode + place on {full}: qimg of all {len(batch)} "
        f"streams equal to the host entropy decode; prepare_batch_entropy "
        f"{t_plan:.3f} s, ans_decode {k3_ms:.3f} ms (on the program's "
        f"padded inputs {k3_padded_ms:.3f} ms), place {place_ms:.3f} "
        f"ms, steps min {int(steps.min())} max {most}, peak device memory "
        f"{peak_gb:.2f} GB")
    log(f"K3 ans_decode on {full}: {k3_ms:.3f} ms, {ns_per_step:.2f} ns a "
        f"step, beside its first port's {K3_PREV_MS} ms; bound "
        f"{k3_bound['bound_ms']:.4f} ms by {k3_bound['bound_by']}, "
        f"{100 * k3_bound['bound_ms'] / k3_ms:.2f}% of it; {card}")
    return {"name": "ans_decode", "route": "cuda",
            "source": "libjxl_tpu_torch/ops/csrc/ans_decode.cu",
            "replaces": "libjxl_tpu/ops/ans_kernel.py:283",
            "launches": 0, "max_abs_err": max(tape_err, qimg_err),
            "exact": tape_err == 0 and qimg_err == 0,
            "ms": k3_ms, "ms_input": full, "ns_per_step": ns_per_step,
            "plain_ms": plain_ms,
            "plain_ms_input": small + " (host clock)", **k3_bound,
            "ms_on_plain_input": small_ms, "place_ms": place_ms,
            "ms_program_plan": k3_padded_ms}


def counted(fn, *args, **kw):
    """fn(*args, **kw) and the launches it made, per kernel."""
    from libjxl_tpu_torch.base.device import launch_counts

    before = launch_counts()
    out = fn(*args, **kw)
    after = launch_counts()
    return out, {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}


def nonzero_counts():
    """The launch counters that moved since the last reset: a counter
    registered by a module that was imported but never launched is 0."""
    from libjxl_tpu_torch.base.device import launch_counts

    return {k: n for k, n in launch_counts().items() if n}


def check_probes(small_streams, batch, dev):
    """Every probe kernel against its twin, exactly: S1-S6 on the scratch
    input and a seeded one (probes.gather.check_probes), S7's stream-copy
    floor at ans_decode's step counts on the small streams and on
    `batch`. Returns {probe: max abs err}."""
    import torch

    from libjxl_tpu_torch.api import tpu_codec
    from libjxl_tpu_torch.ops import kernels
    from libjxl_tpu_torch.probes import gather, prof_kernel

    errs = gather.check_probes(dev)
    errs["S7"] = 0
    for streams in (small_streams, batch):
        lt = tpu_codec.prepare_batch_entropy(streams)[2].to(dev)
        steps = kernels.ans_decode(lt)[2]
        tape, ok = prof_kernel.glue(lt, steps)
        ref, rok = prof_kernel.glue_plain(lt, steps)
        torch.cuda.synchronize()
        check(bool(ok.all()) and bool(rok.all()), "glue flags a lane")
        errs["S7"] = max(errs["S7"],
                         int((tape.long() - ref.long()).abs().max()))
        del tape, ref
    for probe, err in errs.items():
        check(err == 0, f"{probe}'s kernel differs from its twin: max abs "
              f"err {err}")
    log(f"check probes S1-S7: every kernel equal to its twin ({errs})")
    return errs


def drive_probes(batch, dev, errs, card):
    """The probes' path with the counters reset just before: every form
    timed (probes.gather.run_probes) and the device-entropy profile of
    `batch` (probes.prof_kernel.profile_entropy). Prints a line a form and
    the K3 split; returns the probes' JSON records."""
    from libjxl_tpu_torch.base.device import reset_launch_counts
    from libjxl_tpu_torch.probes import gather, prof_kernel

    reset_launch_counts()
    forms, wl = gather.run_probes(dev)
    prof = prof_kernel.profile_entropy(batch, dev)
    launches = nonzero_counts()
    names = [c.name for c, _ in gather.PROBES.values()]
    check(set(launches) == {*names, "glue", "ans_decode"},
          f"probe path launches {launches}")
    for rec in forms:
        log(gather.form_line(rec, card))
    log(gather.wl_line(wl, card))
    log(f"S7 K3 split on {prof['images']} x {SIZE}^2 d1/e3 "
        f"({prof['lanes']} lanes, {prof['steps_max']} steps, t_alloc "
        f"{prof['t_alloc']}): ans_decode {prof['ans_decode_ms'][0]:.4f} ms "
        f"at full (caps {prof['step_points']}: {prof['ans_decode_ms']} ms; "
        f"{prof['ans_decode_ns_per_step']:.3f} ns a step, fixed "
        f"{prof['ans_decode_fixed_ms']:.4f} ms); stream-copy floor "
        f"{prof['floor_ms'][0]:.4f} ms ({prof['floor_ms']} ms; "
        f"{prof['floor_ns_per_step']:.3f} ns a step, fixed "
        f"{prof['floor_fixed_ms']:.4f} ms), twin "
        f"{prof['floor_plain_ms']:.4f} ms; beyond the floor "
        f"{prof['decode_ns_per_step']:.3f} ns a step; tape alloc + zero "
        f"fill {prof['tape_zero_fill_ms']:.4f} ms; {card}")
    log(f"S7 place {prof['place_ms']:.4f} ms; pieces on image 0 "
        f"{prof['place_image0_ms']} ms, summed over the batch "
        f"{prof['place_batch_ms']} ms; {card}")

    src = "libjxl_tpu_torch/ops/csrc/"
    records = []
    for probe, (counter, replaces) in gather.PROBES.items():
        rec = {"name": counter.name, "route": "cuda",
               "source": src + "gather_probe.cu", "replaces": replaces,
               "launches": launches[counter.name],
               "max_abs_err": errs[probe], "exact": errs[probe] == 0}
        if probe == "S6":
            rec.update({k: wl[k] for k in (
                "ms", "plain_ms", "graph_ms", "calls", "us_per_launch",
                "graph_us_per_launch", "plain_us_per_call",
                "library_us_per_call")})
            rec.update(bound(wl["bytes"], 0, wl["library_ms"]))
        else:
            # the probe's first form stands for it; every form beside it
            mine = [r for r, f in zip(forms, gather.FORMS)
                    if f.probe == probe]
            head = mine[0]
            form = next(f for f in gather.FORMS if f.name == head["name"])
            rec.update(bound(*gather.form_work(form, head["ms_iters"])))
            rec.update({
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "ms_input": f"{head['name']}, {head['ms_iters']} steps",
                "ns_per_step": head["ns_per_step"],
                "plain_ns_per_step": head["plain_ns_per_step"],
                "forms": [{k: r[k] for k in (
                    "name", "iters", "ns_per_step", "plain_iters",
                    "plain_ns_per_step")} for r in mine]})
        records.append(rec)
    records.append({
        "name": "glue", "route": "cuda", "source": src + "ans_probe.cu",
        "replaces": "scratch/prof_kernel.py:88",
        "launches": launches["glue"], "max_abs_err": errs["S7"],
        "exact": errs["S7"] == 0, "ms": prof["floor_ms"][0],
        "plain_ms": prof["floor_plain_ms"],
        "ms_input": f"{prof['images']} x {SIZE}^2 d1/e3, {prof['lanes']} "
                    f"lanes, t_alloc {prof['t_alloc']}",
        "ns_per_step": prof["floor_ns_per_step"],
        # each step reads two halfwords and writes a tape word; lane_off,
        # steps and ok once a lane; the CTA table
        **bound(8 * prof["steps_sum"] + 13 * prof["lanes"]
                + 4 * (prof["ctas"] + 1),
                S7_OPS_PER_STEP * prof["steps_sum"]),
        "k3_split": {k: prof[k] for k in (
            "steps_max", "ans_decode_ms", "floor_ms", "step_points",
            "ans_decode_ns_per_step", "ans_decode_fixed_ms",
            "floor_ns_per_step", "floor_fixed_ms", "decode_ns_per_step",
            "tape_zero_fill_ms", "place_ms", "place_image0_ms",
            "place_batch_ms")}})
    return records


def check_images(outs, refs, label):
    worst = 0
    for out, ref in zip(outs, refs):
        check(out.shape == ref.shape,
              f"{label}: shape {out.shape} != host {ref.shape}")
        worst = max(worst, int(np.abs(out.astype(np.int16)
                                      - ref.astype(np.int16)).max()))
    check(worst <= U8_BOUND,
          f"{label}: {worst} u8 steps from the host decode")
    log(f"{label}: {len(outs)} images, max {worst} u8 step(s) from host "
        "decode")


def capture_frame(stream):
    """The host half of decode(..., device=...) on the first frame of
    `stream`: headers and the entropy decode, the frame's state kept for
    the device (api/tpu_codec.make_device_render's input). Returns
    (state, frame header)."""
    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.io.bits import BitReader
    from libjxl_tpu_torch.io.frame_header import FrameHeader
    from libjxl_tpu_torch.vardct.frame import decode_vardct_frame

    r = BitReader(stream)
    fh = FrameHeader(codestream.parse_codestream_header(r))
    fh.read(r)
    cap = {}

    def capture(state):
        cap["state"] = state
        state.restoration_done = state.device_output_done = True

    decode_vardct_frame(r, fh, render_fn=capture, want_qimg=True)
    return cap["state"], fh


def single_split(stream, dev, reps=5):
    """decode(stream, device=dev)'s render of one XYB frame, split: the
    host entropy decode + staging (host clock), then each device stage
    by CUDA events, mean of `reps` after one warm-up: upload,
    pipeline.decode_render_image's stages through its mark hook (K1, the
    size passes, the extra tiles, the true-size mirror, render_tail with
    u8 out), readback. Returns (host s, {stage: ms}, u8 image, the staged
    inputs)."""
    from libjxl_tpu_torch.api import tpu_codec
    from libjxl_tpu_torch.ops import pipeline, staging

    t = time.perf_counter()
    state, fh = capture_frame(stream)
    staged = tpu_codec.stage_image(state, fh, True)
    host_s = time.perf_counter() - t
    check(staged is not None, "the frame's layout keeps it on the host")

    def run(mark):
        args, kw = staging.to_device(staged, dev)
        mark("upload")
        u8 = pipeline.decode_render_image(*args, **kw, mark=mark)
        img = u8.cpu().numpy()
        mark("readback")
        return img

    split, img = stage_ms(run, reps)
    return host_s, split, img, staged


def check_single_kernels(staged, dev):
    """K1 and K2 against their plain twins on one frame's inputs (the
    single-image path's shapes: [3, H, W], one CfL map), timed beside
    them and their bounds. Returns {kernel: record}."""
    import torch

    from libjxl_tpu_torch.ops import kernels, pipeline, staging

    args, kw = staging.to_device(staged, dev)
    qimg, qf, dc, ytox, ytob, dm, igs, xdm, bdm, gab, isg, sad, cs, epf = \
        args
    k1_args = (qimg, qf, dc, ytox, ytob, dm, igs, xdm, bdm)
    with torch.inference_mode():
        got = kernels.dequant_idct8(*k1_args)
        ref = pipeline.decode_xyb_image(*k1_args)
        torch.cuda.synchronize()
        k1_err = max_err(got, ref)
        check(torch.allclose(got, ref, **K1_TOL), f"dequant_idct8 on one "
              f"frame disagrees with decode_xyb_image: max abs err {k1_err}")
        k1 = {"max_abs_err": k1_err,
              "ms": cuda_ms(lambda: kernels.dequant_idct8(*k1_args), 10),
              "plain_ms": cuda_ms(
                  lambda: pipeline.decode_xyb_image(*k1_args), 3),
              **bound(tensor_bytes(qimg, qf, dc, ytox, ytob, dm)
                      + 4 + 4 * qimg.numel(), K1_OPS * qimg.numel())}
        # the frame's XYB as render_tail gets it in decode_render_image
        check(bool(kw["size_passes"]) and bool(kw["extra_tiles"]),
              "the e5 frame has no size pass or no extra tile")
        stages = {}
        pipeline.decode_render_image(
            *args, **kw, mark=lambda stage, t: stages.setdefault(stage, t))
        xyb = stages["true-size mirror"]
        tail = (xyb, gab, isg, sad, cs, epf, kw["pass0_sigma_scale"],
                kw["pass2_sigma_scale"])
        got = kernels.render_tail(*tail, out="xyb")
        ref = pipeline.render_tail_plain(*tail, out="xyb")
        torch.cuda.synchronize()
        tol = tail_tol(epf)
        k2_err = max_err(got, ref)
        check(torch.allclose(got, ref, **tol), f"render_tail on one frame "
              f"(XYB) disagrees with render_tail_plain: max abs err {k2_err}")
        got = kernels.render_tail(*tail, out="u8srgb")
        ref = pipeline.render_tail_plain(*tail, out="u8srgb")
        torch.cuda.synchronize()
        steps = int((got.int() - ref.int()).abs().max())
        check(steps <= U8_BOUND, f"render_tail on one frame (u8) is {steps} "
              "steps from render_tail_plain")
        xyb4 = xyb[None]
        k2 = {"max_abs_err": k2_err, "u8_max_steps": steps,
              "ms": cuda_ms(lambda: kernels.render_tail(*tail,
                                                        out="u8srgb"), 10),
              "plain_ms": cuda_ms(lambda: pipeline.render_tail_plain(
                  *tail, out="u8srgb"), 3),
              **bound(*tail_work(xyb4, isg, sad, gab,
                                 pipeline.EPF_CHAINS[epf], "u8srgb"))}
    return {"dequant_idct8": k1, "render_tail": k2}


# The JAX package's decode(..., device=True) path records on the corpus
# streams (tests/test_torch_device_decode.py holds the port to them on the
# CPU); any stream not named renders "device:u8"
CORPUS_PATHS = {
    "lossy_modular_d1_e5": "host:modular",
    "lossy_flat_d1_e7": "host:unaligned/odd-size transform layout",
    "lossy_gray_d1_e7": "host:unaligned/odd-size transform layout",
    "lossy_rgba_d1_e7": "device:xyb", "lossy_noise_d1_e5": "device:xyb",
    "lossy_hi16_d1_e5": "device:xyb", "jpeg_recon": "device:u8-ycbcr"}
PATH_LAUNCHES = {"device:u8": RENDER_LAUNCHES, "device:xyb": RENDER_LAUNCHES,
                 "device:u8-ycbcr": {"render_tail": 1}}


def oracle_bounds(case):
    """tests/test_conformance_oracle.py's (RMSE, peak) bounds of a lossy
    corpus case against the reference decoder's pixels."""
    dist = float(case.get("encode_args", {}).get("distance", 1.0))
    if dist >= 4.0:
        return 0.5 * dist, int(2 * dist)
    if "noise" in case["name"]:
        return 0.75, 2
    return 0.2, 2


def near_host(got, ref, label):
    """At most U8_BOUND steps from the host decode and, for u8, fewer than
    one pixel value in 1,000 off (tests/test_tpu_codec.py's bound)."""
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{label}: {got.shape} {got.dtype} != host {ref.shape} "
          f"{ref.dtype}")
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    share = float((diff != 0).mean())
    check(int(diff.max()) <= U8_BOUND
          and (got.dtype != np.uint8 or share < 1e-3),
          f"{label}: {int(diff.max())} steps, {share:.2e} of values off "
          "the host decode")
    return int(diff.max()), share


def drive_single(e5, odd5, ycc, dev, smi):
    """The single-image path: codestream.decode(..., device=dev) on the
    2048^2 e5 frames, the 1021x765 e5 frames, the 2048^2 4:2:0 YCbCr
    frame and the conformance corpus, each a (stream, host u8) list, with
    the counters reset just before and read just after. Checks each
    frame's path record, pixels and launches; prints the latency split
    of one 2048^2 frame, its kernels against their twins and the MP/s
    beside the host decode. Returns (launches on the path, the kernels'
    single-image records)."""
    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.base.device import reset_launch_counts

    root = os.path.dirname(os.path.abspath(__file__))
    corpus_dir = os.path.join(root, "tests", "data", "conformance")
    with open(os.path.join(corpus_dir, "manifest.json")) as f:
        cases = [c for c in json.load(f)["cases"]
                 if c["kind"] != "lossless"]
    corpus = []
    for case in cases:
        with open(os.path.join(corpus_dir, case["name"] + ".jxl"),
                  "rb") as f:
            data = f.read()
        corpus.append((case, data, codestream.decode(data, device=None)[0]))
    # the filtered YCbCr frame's reference is the same render on the CPU
    # (the plain twins): the JAX package's own device and host renders of
    # such a frame differ by up to 2 steps (its device path filters the
    # block-padded planes)
    ycc = (ycc[0], codestream.decode(ycc[0], device="cpu")[0])
    # the frames' expected (label, record): the true-size crop keeps the
    # 1021x765 write on the host (XYB back)
    frames = ([(f"{SIZE}x{SIZE} e5 #{i}", "device:u8", s, r)
               for i, (s, r) in enumerate(e5)]
              + [(f"{ODD_SIZE[1]}x{ODD_SIZE[0]} e5 #{i}", "device:xyb", s, r)
                 for i, (s, r) in enumerate(odd5)]
              + [(f"{SIZE}x{SIZE} 4:2:0 YCbCr", "device:u8-ycbcr", *ycc)]
              + [(c["name"], CORPUS_PATHS.get(c["name"], "device:u8"), d, r)
                 for c, d, r in corpus])
    outs, secs = {}, {}
    reset_launch_counts()
    for label, path, data, _ in frames:
        info = {}
        t = time.perf_counter()
        (img, _), n = counted(codestream.decode, data, device=dev,
                              decode_info=info)
        secs[label] = time.perf_counter() - t
        check(info["path"] == path, f"{label}: path {info['path']}, the "
              f"JAX package's is {path}")
        check(n == PATH_LAUNCHES.get(path, {}),
              f"{label} ({path}) launches {n}")
        outs[label] = img
    launches = nonzero_counts()
    want = {}
    for _, path, _, _ in frames:
        for k, v in PATH_LAUNCHES.get(path, {}).items():
            want[k] = want.get(k, 0) + v
    check(launches == want, f"single-image path launches {launches}, "
          f"expected {want}")
    worst = {}
    for label, path, _, ref in frames:
        got = outs[label]
        if ref.ndim == 3 and ref.shape[2] == 3 and got.shape[2] > 3:
            got = got[:, :, :3]
        worst[label] = near_host(got, ref, f"decode(device) {label}"
                                 + (" vs device='cpu'" if "YCbCr" in label
                                    else ""))
    for case, _, _ in corpus:
        if case["kind"] != "lossy":
            continue  # jpeg_recon: its bound is the host decode's above
        oracle = np.load(os.path.join(corpus_dir, case["name"] + ".npy"))
        got = outs[case["name"]]
        nc = min(got.shape[2], oracle.shape[2])
        d = got[:, :, :nc].astype(np.float64) - oracle[:, :, :nc]
        rmse, peak = float(np.sqrt((d ** 2).mean())), int(np.abs(d).max())
        limit, peak_limit = oracle_bounds(case)
        check(rmse < limit and peak <= peak_limit,
              f"{case['name']}: RMSE {rmse} peak {peak} against the "
              f"reference decoder (bounds {limit}, {peak_limit})")
    log(f"decode(device) single-image path: {len(frames)} frames, paths "
        "as the JAX package's, launches " + json.dumps(launches)
        + "; worst (steps, share off) from the host decode (the YCbCr "
        "frame: from decode(device='cpu')): "
        + ", ".join(f"{k} {v[0]} {v[1]:.2e}" for k, v in worst.items()
                    if not k.startswith(("lossy", "jpeg"))))

    host_s, split, img, staged = single_split(e5[0][0], dev)
    check(np.array_equal(img, outs[frames[0][0]]),
          "the split's stages differ from decode(device)'s output")
    total_ms = sum(split.values())
    log(f"phase single-image split ({SIZE}x{SIZE} d1/e5, one frame): host "
        f"entropy + staging {host_s * 1e3:.2f} ms (host clock); "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
        + f"; device stages {total_ms:.4f} ms (CUDA events, mean of 5); "
        f"{smi}")
    single = check_single_kernels(staged, dev)
    for name, rec in single.items():
        log(f"check {name} on one {SIZE}x{SIZE} e5 frame: max abs err "
            f"{rec['max_abs_err']}; {rec['ms']:.4f} ms vs plain "
            f"{rec['plain_ms']:.4f} ms; bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}, "
            f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it); {smi}")
    t = time.perf_counter()
    codestream.decode(e5[0][0], device=None)
    host_decode_s = time.perf_counter() - t
    mp = SIZE * SIZE / 1e6
    dev_s = [secs[f[0]] for f in frames[:len(e5)]]
    log(f"phase single-image decode ({SIZE}x{SIZE} d1/e5, host clock): "
        f"decode(device) {min(dev_s):.3f} s best of {len(dev_s)} (mean "
        f"{np.mean(dev_s):.3f}), {mp / min(dev_s):.2f} MP/s; host decode "
        f"{host_decode_s:.3f} s, {mp / host_decode_s:.2f} MP/s; {smi}")
    return launches, single


def drive_mixed_batch(main16, odd, e5_1024, piped16, odd_outs, dev):
    """codestream.decode_batch(..., device=dev) on an interleaved mixed
    list: 16 x 2048^2 e3, 2 x 1021x765 e3 and one 1024^2 e5, each a
    (stream, host u8) list, with the counters reset just before. The list
    fails the batch gate, so the call buckets: each e3 bucket is one
    batched render (equal to the same batch's earlier render), the e5
    singleton goes through decode(device); order is kept."""
    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.base.device import reset_launch_counts

    order = ([("m", 0), ("o", 0), ("e", 0)] + [("m", i) for i in range(1, 8)]
             + [("o", 1)] + [("m", i) for i in range(8, 16)])
    pick = {"m": main16, "o": odd, "e": e5_1024}
    streams = [pick[k][i][0] for k, i in order]
    reset_launch_counts()
    t = time.perf_counter()
    outs = codestream.decode_batch(streams, device=dev)
    secs = time.perf_counter() - t
    launches = nonzero_counts()
    check(launches == {"dequant_idct8": 3, "render_tail": 3},
          f"mixed decode_batch launches {launches}: two batched buckets "
          "and one singleton expected")
    check(len(outs) == len(streams), "mixed decode_batch lost streams")
    for (k, i), out in zip(order, outs):
        near_host(out, pick[k][i][1], f"mixed decode_batch {k}{i}")
        same = {"m": piped16, "o": odd_outs}.get(k)
        if same is not None:
            check(np.array_equal(out, same[i]), f"mixed decode_batch {k}{i} "
                  "differs from its batch's own render")
    log(f"phase mixed decode_batch ({len(streams)} streams, 3 geometries): "
        f"{secs:.3f} s, order kept, launches {json.dumps(launches)}")
    return launches


def mp_s(pixels, secs):
    return pixels / 1e6 / secs


def encode_arrays(img, device):
    """tpu_codec.encode_lossy_tpu(img, device=device): its bytes and the
    encode step's arrays as read back (qimg, nz, dc, qf, ytox, ytob,
    sharp), taken through its mark hook."""
    from libjxl_tpu_torch.api import tpu_codec

    got = {}

    def mark(stage, value):
        if stage == "readback":
            got["arrays"] = value

    data = tpu_codec.encode_lossy_tpu(img, distance=1.0, device=device,
                                      mark=mark)
    return data, got["arrays"]


def twin_agreement(card, cpu, label, names):
    """The card's arrays against the CPU twin's on the same input (named
    by `names`): the count of values that differ, each array's largest
    difference. Integer arrays may differ by one step where a float sits
    on a rounding boundary (cuBLAS and the CPU sum the DCT in other
    orders), in fewer than one value in 10,000; the zero counts nz move
    by at most one a differing coefficient; float arrays within 1e-5."""
    out = {}
    for name, a, b in zip(names, card, cpu):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{label} {name}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
        n = int((diff != 0).sum())
        out[name] = {"differ": n, "of": int(a.size),
                     "max_abs": float(diff.max())}
        if a.dtype.kind == "f":
            ok = np.allclose(a, b, rtol=1e-5, atol=1e-5)
        elif name == "nz":
            ok = diff.sum() <= out["qimg"]["differ"]
        else:
            ok = diff.max() <= 1 and n <= max(1, a.size // 10000)
        check(ok, f"{label} {name}: card vs CPU twin: {n} values differ, "
              f"max {diff.max()}")
    return out


ENCODE_ARRAYS = ("qimg", "nz", "dc", "qf", "ytox", "ytob", "sharp")


def encode_split(img, dev, reps=3):
    """encode_lossy_tpu's stages (tpu_codec.ENCODE_STAGES) on one image,
    mean of `reps` after a warm-up: the device stages (srgb2lin, the
    encode step) by CUDA events, the rest (host setup, the pageable
    upload, the readback, the host entropy coding) by host clock, the
    device synchronized at each stage's end. Returns {stage: ms}."""
    import torch

    from libjxl_tpu_torch.api import tpu_codec

    total = {}
    for rep in range(reps + 1):
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks = [(None, time.perf_counter(), ev)]

        def mark(stage, _value, marks=marks):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            torch.cuda.synchronize()
            marks.append((stage, time.perf_counter(), e))

        tpu_codec.encode_lossy_tpu(img, distance=1.0, device=dev, mark=mark)
        if rep:
            for (_, t0, e0), (stage, t1, e1) in zip(marks, marks[1:]):
                ms = e0.elapsed_time(e1) if stage in ("srgb2lin",
                                                      "encode step") \
                    else (t1 - t0) * 1e3
                total[stage] = total.get(stage, 0.0) + ms / reps
    return total


def drive_encode(dev, smi):
    """The one-shot device encode: codestream.encode_lossy(...,
    device=dev) of ENCODE_FRAMES 2048^2 d1/e3 photos, counters reset just
    before (the path has no hand kernel: nothing may launch), beside the
    host encode of the same images; the card's arrays against the CPU
    twin's on a 512^2 and a 2048^2 image; the card's stream decoded by
    the host and by decode(device=dev), within 1 u8 step of each other;
    the stage split. Returns the phase's record."""
    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.base.device import reset_launch_counts

    imgs = [make_image(SIZE, SIZE, 500 + i) for i in range(ENCODE_FRAMES)]
    codestream.encode_lossy(make_image(256, 256, 509), effort=3,
                            device=dev)  # first torch calls on the card
    reset_launch_counts()
    dev_s, streams = [], []
    for img in imgs:
        t = time.perf_counter()
        streams.append(codestream.encode_lossy(img, distance=1.0, effort=3,
                                               device=dev))
        dev_s.append(time.perf_counter() - t)
    launches = nonzero_counts()
    check(launches == {}, f"the encode path launched kernels: {launches}")
    host_s = []
    for img, data in zip(imgs, streams):
        t = time.perf_counter()
        host = codestream.encode_lossy(img, distance=1.0, effort=3,
                                       device=None)
        host_s.append(time.perf_counter() - t)
        log(f"encode {SIZE}x{SIZE} d1/e3: device {len(data)} B, host "
            f"{len(host)} B, bytes {'equal' if host == data else 'differ'}")
    agreement = {}
    for label, img in ((f"512x512", make_image(512, 512, 510)),
                       (f"{SIZE}x{SIZE}", imgs[0])):
        card_b, card = encode_arrays(img, dev)
        cpu_b, cpu = encode_arrays(img, "cpu")
        agreement[label] = {"bytes_equal": card_b == cpu_b,
                            **twin_agreement(card, cpu, f"encode {label}",
                                             ENCODE_ARRAYS)}
        log(f"encode {label}: card vs CPU twin arrays "
            + ", ".join(f"{k} {v['differ']}/{v['of']} differ "
                        f"(max {v['max_abs']:.3g})"
                        for k, v in agreement[label].items()
                        if isinstance(v, dict))
            + f"; bytes {'equal' if card_b == cpu_b else 'differ'}")
    got = codestream.decode(streams[0], device=dev)[0]
    ref = codestream.decode(streams[0], device=None)[0]
    steps, share = near_host(got, ref, "device-encoded stream: "
                             "decode(device) vs host decode")
    split = encode_split(imgs[0], dev)
    mp = SIZE * SIZE * len(imgs)
    rec = {"images": f"{len(imgs)} x {SIZE}^2 d1/e3", "launches": launches,
           "device_s": dev_s, "host_s": host_s,
           "device_mp_s": mp_s(mp, sum(dev_s)),
           "host_mp_s": mp_s(mp, sum(host_s)), "split_ms": split,
           "twin": agreement, "decode_steps": steps, "decode_share": share}
    log(f"phase device encode ({rec['images']}, host clock): "
        f"encode_lossy(device) {rec['device_mp_s']:.2f} MP/s (best "
        f"{min(dev_s):.3f} s), host encode {rec['host_mp_s']:.2f} MP/s "
        f"(best {min(host_s):.3f} s); split of one image: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
        + f" (srgb2lin, encode step: CUDA events; the rest host clock); "
        f"{smi}")
    return rec


def drive_streaming(img, dev, smi):
    """The streaming encode of one BIG^2 photo (four 2048^2 DC groups):
    encode_lossy_streaming(..., device=dev) with hosts=1 and hosts=2,
    counters reset just before (no hand kernel: nothing may launch);
    equal bytes, MP/s, peak device memory; the first DC group's step on
    the card against the CPU twin on the same inputs. Returns (stream,
    record)."""
    import torch

    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.base.device import reset_launch_counts
    from libjxl_tpu_torch.vardct import streaming

    step = streaming.step
    steps = []

    def recorded(*args):
        out = step(*args)
        steps.append((args, out))
        return out

    runs = {}
    streaming.step = recorded
    try:
        for hosts in (1, 2):
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            data = codestream.encode_lossy_streaming(img, distance=1.0,
                                                     hosts=hosts,
                                                     device=dev)
            secs = time.perf_counter() - t
            runs[hosts] = (data, secs,
                           torch.cuda.max_memory_allocated() / 1e9,
                           nonzero_counts())
    finally:
        streaming.step = step
    check(runs[1][0] == runs[2][0], "streaming hosts=2 bytes differ from "
          "hosts=1")
    for hosts, (_, _, _, n) in runs.items():
        check(n == {}, f"streaming hosts={hosts} launched kernels: {n}")
    args, card = steps[0]
    twin = twin_agreement(card, step(*args[:-1], torch.device("cpu")),
                          "streaming step", ("q", "dc", "qf", "ytox",
                                             "ytob", "sharp"))
    data = runs[1][0]
    out = codestream.decode(data, device=dev)[0]
    err = float(np.abs(out.astype(int) - img.astype(int)).mean())
    check(err < 8.0, f"streamed {BIG}^2 mean abs error {err}")
    mp = img.shape[0] * img.shape[1]
    rec = {"image": f"{BIG}^2 d1, {len(steps) // 2} DC groups",
           "launches": {}, "bytes": len(data),
           "mp_s": {h: mp_s(mp, r[1]) for h, r in runs.items()},
           "secs": {h: r[1] for h, r in runs.items()},
           "peak_gb": {h: r[2] for h, r in runs.items()},
           "step_twin": twin, "mean_abs_err": err}
    log(f"phase streaming encode ({rec['image']}, host clock): hosts=1 "
        f"{runs[1][1]:.3f} s ({rec['mp_s'][1]:.2f} MP/s), hosts=2 "
        f"{runs[2][1]:.3f} s ({rec['mp_s'][2]:.2f} MP/s), bytes equal; "
        f"peak device memory {runs[1][2]:.3f} / {runs[2][2]:.3f} GB; "
        "first DC group's step vs CPU twin: "
        + ", ".join(f"{k} {v['differ']}/{v['of']}" for k, v in twin.items())
        + f"; decoded mean abs error {err:.3f}; {smi}")
    return data, rec


def strip_split(stream, dev):
    """decode_vardct_strips(..., device=dev) of `stream` with its mark
    hook: each stage's CUDA-event ms summed over the strips, then divided
    by their number; the "strip" stage is the time from the previous
    strip's end (the host entropy decode of the next group row). Returns
    ({stage: mean ms a strip}, strips)."""
    import torch

    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.io.bits import BitReader
    from libjxl_tpu_torch.io.frame_header import FrameHeader
    from libjxl_tpu_torch.vardct.low_memory import decode_vardct_strips

    r = BitReader(stream)
    fh = FrameHeader(codestream.parse_codestream_header(r))
    fh.read(r)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    events = [(None, ev)]

    def mark(stage, _value):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append((stage, e))

    strips = list(decode_vardct_strips(r, fh, device=dev, mark=mark))
    torch.cuda.synchronize()
    total = {}
    for (_, a), (stage, b) in zip(events, events[1:]):
        total[stage] = total.get(stage, 0.0) + a.elapsed_time(b)
    return {k: v / len(strips) for k, v in total.items()}, strips


def check_strip_kernels(stream, dev):
    """K1 and K2 against their plain twins on the strip path's own inputs:
    decode_vardct_strips(stream, device=dev) with a mark hook that keeps
    the render arguments and the true-size mirror's output (render_tail's
    input) of the first strip, the second (interior when there are three
    or more) and the last (the true-size one where the frame is not a
    multiple of 8). Each kernel is held to its twin on each of them as
    check_single_kernels does: dequant_idct8 at K1_TOL, render_tail's XYB
    at tail_tol(epf) and its u8 within U8_BOUND steps; then both are
    timed back to back on the second strip, each launch copying its
    tables as on the strip path. Returns {kernel: record}."""
    import torch

    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.io.bits import BitReader
    from libjxl_tpu_torch.io.frame_header import FrameHeader
    from libjxl_tpu_torch.ops import kernels, pipeline
    from libjxl_tpu_torch.vardct.low_memory import decode_vardct_strips

    r = BitReader(stream)
    fh = FrameHeader(codestream.parse_codestream_header(r))
    fh.read(r)
    kept, started = {}, [0]

    def mark(stage, value):
        if stage == "strip":
            i = started[0]
            started[0] += 1
            if i - 1 >= 2:  # keep the first two strips and the latest
                del kept[i - 1]
            kept[i] = {}
        elif stage in ("upload", "true-size mirror"):
            kept[started[0] - 1][stage] = value

    n = len(list(decode_vardct_strips(r, fh, device=dev, mark=mark)))
    check(sorted(kept) == sorted({0, min(1, n - 1), n - 1})
          and all(len(k) == 2 for k in kept.values()),
          f"the strip path rendered strips {sorted(kept)} of {n} without "
          "the device")
    k1 = {"max_abs_err": 0.0, "strips": []}
    k2 = {"max_abs_err": 0.0, "u8_max_steps": 0, "strips": []}
    with torch.inference_mode():
        for i in sorted(kept):
            (args, kw), xyb = kept[i]["upload"], kept[i]["true-size mirror"]
            where = (f"strip {i} of {n} ({xyb.shape[1]}x{xyb.shape[2]}, "
                     f"true size {kw['true_size']})")
            got = kernels.dequant_idct8(*args[:9])
            ref = pipeline.decode_xyb_image(*args[:9])
            torch.cuda.synchronize()
            err = max_err(got, ref)
            check(torch.allclose(got, ref, **K1_TOL), f"dequant_idct8 on "
                  f"{where} disagrees with decode_xyb_image: max abs err "
                  f"{err}")
            k1["max_abs_err"] = max(k1["max_abs_err"], err)
            k1["strips"].append({"strip": i, "rows": xyb.shape[1],
                                 "max_abs_err": err})
            gab, isg, sad, cs, epf = args[9:14]
            tail = (xyb, gab, isg, sad, cs, epf, kw["pass0_sigma_scale"],
                    kw["pass2_sigma_scale"])
            got = kernels.render_tail(*tail, out="xyb")
            ref = pipeline.render_tail_plain(*tail, out="xyb")
            torch.cuda.synchronize()
            err = max_err(got, ref)
            check(torch.allclose(got, ref, **tail_tol(epf)), f"render_tail "
                  f"on {where} (XYB) disagrees with render_tail_plain: max "
                  f"abs err {err}")
            got = kernels.render_tail(*tail, out="u8srgb")
            ref = pipeline.render_tail_plain(*tail, out="u8srgb")
            torch.cuda.synchronize()
            steps = int((got.int() - ref.int()).abs().max())
            check(steps <= U8_BOUND, f"render_tail on {where} (u8) is "
                  f"{steps} steps from render_tail_plain")
            k2["max_abs_err"] = max(k2["max_abs_err"], err)
            k2["u8_max_steps"] = max(k2["u8_max_steps"], steps)
            k2["strips"].append({"strip": i, "rows": xyb.shape[1],
                                 "true_size": kw["true_size"],
                                 "max_abs_err": err, "u8_max_steps": steps})
        (args, kw), xyb = kept[min(1, n - 1)]["upload"], \
            kept[min(1, n - 1)]["true-size mirror"]
        qimg = args[0]
        k1.update({"ms": cuda_ms(lambda: kernels.dequant_idct8(*args[:9]),
                                 20),
                   "plain_ms": cuda_ms(
                       lambda: pipeline.decode_xyb_image(*args[:9]), 3),
                   **bound(tensor_bytes(*args[:6]) + 4 + 4 * qimg.numel(),
                           K1_OPS * qimg.numel())})
        gab, isg, sad, cs, epf = args[9:14]
        tail = (xyb, gab, isg, sad, cs, epf, kw["pass0_sigma_scale"],
                kw["pass2_sigma_scale"])
        k2.update({"ms": cuda_ms(lambda: kernels.render_tail(
            *tail, out="u8srgb"), 20),
                   "plain_ms": cuda_ms(lambda: pipeline.render_tail_plain(
                       *tail, out="u8srgb"), 3),
                   **bound(*tail_work(xyb[None], isg, sad, gab,
                                      pipeline.EPF_CHAINS[epf], "u8srgb"))})
    return {"dequant_idct8": k1, "render_tail": k2}


def drive_strips(img, e5_stream, odd_stream, dev, smi):
    """The bounded-memory decode of the BIG^2 photo at e3 (encoded by
    encode_lossy(device=dev)): decode_rows(s, device=dev) with the counters
    reset just before: every strip u8, dequant_idct8 and render_tail once
    a strip, the rows within 1 u8 step of decode(s, device=dev) and of
    decode_rows(s, device=None); the per-strip split; both kernels held to
    their twins on its strips' inputs (check_strip_kernels); MP/s and peak
    device memory beside the whole-image decode's. Then the same for an
    e3 stream whose size is not a multiple of 8 (its last strip has a
    true size): rows within 1 step of decode(device=dev), kernels against
    twins. Then an e5 stream, outside the device scope: the host strips,
    no launch, decode_rows(device=None)'s rows. Returns (launches,
    record)."""
    import torch

    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.base.device import reset_launch_counts

    t = time.perf_counter()
    data = codestream.encode_lossy(img, distance=1.0, effort=3, device=dev)
    enc_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    whole = codestream.decode(data, device=dev)[0]
    whole_s = time.perf_counter() - t
    whole_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t = time.perf_counter()
    rows = list(codestream.decode_rows(data, device=dev))
    rows_s = time.perf_counter() - t
    launches = nonzero_counts()
    rows_gb = torch.cuda.max_memory_allocated() / 1e9
    n = len(rows)
    check(all(r.dtype == np.uint8 for _, r in rows),
          "a device strip is not u8")
    check(launches == {"dequant_idct8": n, "render_tail": n},
          f"strip path launches {launches} for {n} strips")
    cat = np.concatenate([r for _, r in rows], axis=0)
    near_host(cat, whole, "decode_rows(device) vs decode(device)")
    t = time.perf_counter()
    host = np.concatenate([r for _, r in codestream.decode_rows(
        data, device=None)], axis=0)
    host_s = time.perf_counter() - t
    steps, share = near_host(cat, host, "decode_rows(device) vs "
                             "decode_rows(device=None)")
    split, strips = strip_split(data, dev)
    check(np.array_equal(np.concatenate([r for _, r in strips], axis=0),
                         cat), "the split's strips differ from decode_rows'")
    twins = check_strip_kernels(data, dev)
    odd_rows = np.concatenate([r for _, r in codestream.decode_rows(
        odd_stream, device=dev)], axis=0)
    odd_steps, _ = near_host(odd_rows, codestream.decode(
        odd_stream, device=dev)[0], "decode_rows(device) vs decode(device), "
        f"{odd_rows.shape[1]}x{odd_rows.shape[0]}")
    odd_twins = check_strip_kernels(odd_stream, dev)
    for name, rec in twins.items():
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 odd_twins[name]["max_abs_err"])
        rec["odd_strips"] = odd_twins[name]["strips"]
    twins["render_tail"]["u8_max_steps"] = max(
        twins["render_tail"]["u8_max_steps"],
        odd_twins["render_tail"]["u8_max_steps"])
    reset_launch_counts()
    e5_rows = np.concatenate([r for _, r in codestream.decode_rows(
        e5_stream, device=dev)], axis=0)
    e5_launches = nonzero_counts()
    check(e5_launches == {}, f"the e5 stream launched {e5_launches}: it is "
          "outside the strips' device scope")
    check(np.array_equal(e5_rows, np.concatenate(
        [r for _, r in codestream.decode_rows(e5_stream, device=None)],
        axis=0)), "the e5 stream's strips differ from the host strips")
    mp = img.shape[0] * img.shape[1]
    rec = {"image": f"{BIG}^2 d1/e3, device-encoded", "strips": n,
           "launches": launches, "encode_s": enc_s,
           "rows_mp_s": mp_s(mp, rows_s), "whole_mp_s": mp_s(mp, whole_s),
           "host_rows_mp_s": mp_s(mp, host_s),
           "peak_gb": rows_gb, "whole_peak_gb": whole_gb,
           "split_ms_per_strip": split, "twins": twins,
           "steps_vs_host": steps, "share_vs_host": share,
           "odd_steps_vs_whole": odd_steps}
    log(f"phase bounded-memory strips ({rec['image']}, {n} strips): "
        f"decode_rows(device) {rows_s:.3f} s ({rec['rows_mp_s']:.2f} MP/s)"
        f", peak device memory {rows_gb:.3f} GB beside decode(device)'s "
        f"{whole_gb:.3f} GB ({whole_s:.3f} s); host strips {host_s:.3f} s; "
        f"per strip (CUDA events): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
        + "; on the second strip's inputs, back to back: " + ", ".join(
            f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, bound "
            f"{v['bound_ms']:.4f})" for k, v in twins.items())
        + "; twins agree on strips "
        + str([r["strip"] for r in twins["dequant_idct8"]["strips"]])
        + f" and on all {len(twins['dequant_idct8']['odd_strips'])} of the "
        f"{odd_rows.shape[1]}x{odd_rows.shape[0]} stream (K1 max abs err "
        f"{twins['dequant_idct8']['max_abs_err']:.3g}, render_tail "
        f"{twins['render_tail']['max_abs_err']:.3g}, u8 "
        f"{twins['render_tail']['u8_max_steps']} step(s))"
        + f"; max {steps} step(s) from the host strips; e5 stream: host "
        f"strips, no launch; device encode of the image {enc_s:.3f} s; "
        f"{smi}")
    return launches, rec



# The encoder heuristics phase (drive_heuristics): 2048^2 d1 photos at e5
# and e7 on the card beside the host encode; the host e7 reference is
# taken at E7_HOST_SIDE (at 2048^2 it alone takes about as long as the
# rest of the phase)
HEUR_E5_SEEDS = (800, 801)
HEUR_E7_SEED = 802
E7_HOST_SIDE = 1024
E7_ROUNDS = 2  # min(4, effort - 5) refinement rounds at e7
DIFFMAP_CHECK_SIDE = 512
# the card's diffmap against the CPU twin: relative, with a 1e-3 floor, at
# tests/test_butteraugli_jax.py's device-vs-host bound (the blur products
# sum in another order and the opsin X channel cancels, so an ulp there
# moves the map by up to ~1e-4)
DIFFMAP_REL = 2e-3
TILE_RTOL = 1e-5  # tile costs, card against the CPU twin
# e7 ladder: (rows, cols, strategy name) of every candidate transform
LADDER = ((8, 8, "DCT"), (16, 16, "DCT16X16"), (16, 8, "DCT16X8"),
          (8, 16, "DCT8X16"), (32, 32, "DCT32X32"), (32, 16, "DCT32X16"),
          (16, 32, "DCT16X32"), (64, 64, "DCT64X64"), (64, 32, "DCT64X32"),
          (32, 64, "DCT32X64"), (128, 128, "DCT128X128"),
          (128, 64, "DCT128X64"), (64, 128, "DCT64X128"),
          (256, 256, "DCT256X256"), (256, 128, "DCT256X128"),
          (128, 256, "DCT128X256"))


def torch_ops(fn):
    """fn() and the number of torch operations it dispatched, views
    excluded: each of those is about one launch on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


class HeuristicsSpy:
    """Wraps the encode's device stages while installed: the CUDA-event
    time of every _tile_cost_device call and _refine_device call, a
    snapshot of the first AC-strategy search's inputs, and render_tail's
    first call's arguments (the trial's own inputs)."""

    def __init__(self):
        from libjxl_tpu_torch.ops import kernels
        from libjxl_tpu_torch.vardct import frame, heuristics

        self.targets = ((frame, "_tile_cost_device", "acs costs"),
                        (heuristics, "_refine_device", "refinement"),
                        (frame, "_choose_ac_strategies", None),
                        (kernels, "render_tail", None))
        self.real = {name: getattr(mod, name)
                     for mod, name, _ in self.targets}
        self.events = []
        self.acs_inputs = None
        self.tail_args = None

    def _timed(self, name, stage):
        import torch

        real = self.real[name]

        def wrapped(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = real(*args, **kw)
            b.record()
            self.events.append((stage, a, b))
            return out

        return wrapped

    def _search(self, state, xyb, *args, **kw):
        if self.acs_inputs is None:
            self.acs_inputs = (self.snapshot(state), xyb.copy(), args, kw)
        return self.real["_choose_ac_strategies"](state, xyb, *args, **kw)

    def _tail(self, *args, **kw):
        if self.tail_args is None:
            self.tail_args = ([a.clone() if hasattr(a, "clone") else a
                               for a in args], dict(kw))
        return self.real["render_tail"](*args, **kw)

    @staticmethod
    def snapshot(state):
        """A copy of an encoder state that an AC-strategy search may
        change without touching `state` (the arrays it writes copied)."""
        import copy

        snap = copy.copy(state)
        for name in ("raw_quant_field", "strategy", "is_origin"):
            setattr(snap, name, getattr(state, name).copy())
        snap.__dict__.pop("_xyb_dev", None)
        return snap

    def __enter__(self):
        for mod, name, stage in self.targets:
            wrapper = self._timed(name, stage) if stage \
                else {"_choose_ac_strategies": self._search,
                      "render_tail": self._tail}[name]
            setattr(mod, name, wrapper)
        return self

    def __exit__(self, *exc):
        for mod, name, _ in self.targets:
            setattr(mod, name, self.real[name])

    def split(self):
        """{stage: CUDA-event ms} of the calls since the last split."""
        import torch

        torch.cuda.synchronize()
        out = {}
        for stage, a, b in self.events:
            out[stage] = out.get(stage, 0.0) + a.elapsed_time(b)
        self.events = []
        return out


def encode_timed(img, effort, device, spy=None):
    """codestream.encode_lossy(img, d1, effort, device), the launch
    counters set to 0 just before: (stream, host seconds, the strategy of
    every block, the launches it made, the split of the device stages when
    a spy is installed)."""
    import torch

    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.base.device import reset_launch_counts

    got = {}
    if spy is not None:
        spy.split()
    reset_launch_counts()
    t = time.perf_counter()
    data = codestream.encode_lossy(
        img, distance=1.0, effort=effort, device=device,
        debug_cb=lambda st: got.update(strategy=st.strategy.copy()))
    if device is not None:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    n = nonzero_counts()
    split = spy.split() if spy is not None else {}
    if split:
        split["rest (host clock)"] = secs * 1e3 - sum(split.values())
    return data, secs, got["strategy"], n, split


def check_tile_costs(acs_inputs, dev):
    """The card's _tile_cost_device against its CPU twin on one search's
    own inputs, every tile size of the e7 ladder: the largest relative
    difference, the tiles off by more than TILE_RTOL (at most one in 1,000
    a size: a coefficient whose float sits on a rounding boundary moves
    its tile's bits), the card's CUDA-event ms beside the CPU twin's and
    the host numpy _batched_tile_cost's host-clock ms; then the whole
    search run from the card's costs and from the twin's (the arrays just
    computed), and the blocks whose strategy differs. Returns the
    record."""
    import torch

    from libjxl_tpu_torch.vardct import ac_strategy as acs
    from libjxl_tpu_torch.vardct import frame

    state, xyb, args, kw = acs_inputs
    cpu = torch.device("cpu")
    nby, nbx = state.fd.ysize_blocks, state.fd.xsize_blocks
    sizes, costs = {}, ({}, {})
    for rows, cols, name in LADDER:
        kind = acs.QUANT_TABLE[getattr(acs, name)]
        tby, tbx = nby // (rows // 8), nbx // (cols // 8)
        a = (HeuristicsSpy.snapshot(state), xyb, rows, cols, kind, tby, tbx)
        card = frame._tile_cost_device(*a, dev)
        t = time.perf_counter()
        twin = frame._tile_cost_device(*a, cpu)
        twin_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        host = frame._batched_tile_cost(*a[:5])
        host_ms = (time.perf_counter() - t) * 1e3
        costs[0][rows, cols], costs[1][rows, cols] = card, twin
        rel = np.abs(card - twin) / np.abs(twin)
        off = int((rel > TILE_RTOL).sum())
        check(card.shape == twin.shape == host.shape and np.isfinite(
            card).all() and off <= max(1, card.size // 1000),
            f"tile cost {rows}x{cols}: {off} of {card.size} tiles off the "
            f"CPU twin by more than {TILE_RTOL} (max {rel.max():.3g})")
        frame._tile_cost_device(*a, dev)  # captured here if not before
        sizes[f"{rows}x{cols}"] = {
            "tiles": int(card.size), "max_rel": float(rel.max()),
            "off": off, "host_max_rel": float(
                (np.abs(card - host) / np.abs(host)).max()),
            "ms": cuda_ms(lambda: frame._tile_cost_device(*a, dev), 3),
            "twin_ms": twin_ms, "host_ms": host_ms}
    strategies = []
    real = frame._batched_tile_cost
    try:
        for side in costs:
            frame._batched_tile_cost = \
                lambda _st, _x, rows, cols, *_, side=side: side[rows, cols]
            st = HeuristicsSpy.snapshot(state)
            frame._choose_ac_strategies(st, xyb, *args, **kw)
            strategies.append(st.strategy)
    finally:
        frame._batched_tile_cost = real
    differ = int((strategies[0] != strategies[1]).sum())
    return {"image": f"{nbx * 8}x{nby * 8}", "sizes": sizes,
            "strategy_blocks_differ": differ, "blocks": int(nby * nbx)}


def check_diffmap(dev):
    """butteraugli_diffmap_torch on the card against the CPU twin at
    DIFFMAP_CHECK_SIDE^2 (a photo against itself plus noise), then at
    SIZE^2 its eager body's CUDA-event ms, peak device memory and torch
    operations (the program's replay is drive_programs')."""
    import torch

    from libjxl_tpu_torch.metrics.butteraugli_torch import (
        _diffmap, butteraugli_diffmap_torch)
    from libjxl_tpu_torch.ops.xyb import srgb_u8_to_linear

    def pair(n, seed):
        lin = np.moveaxis(srgb_u8_to_linear(make_image(n, n, seed)), -1, 0)
        rng = np.random.default_rng(seed)
        other = np.clip(lin + rng.normal(0, 0.01, lin.shape), 0, 1)
        return (torch.from_numpy(np.ascontiguousarray(lin, np.float32)),
                torch.from_numpy(np.ascontiguousarray(other, np.float32)))

    a, b = pair(DIFFMAP_CHECK_SIDE, 810)
    twin = butteraugli_diffmap_torch(a, b)
    card = butteraugli_diffmap_torch(a.to(dev), b.to(dev)).cpu()
    rel = float(((card - twin).abs() / (twin.abs() + 1e-3)).max())
    check(card.shape == twin.shape and bool(torch.isfinite(card).all())
          and rel <= DIFFMAP_REL, f"diffmap on the card vs the CPU twin at "
          f"{DIFFMAP_CHECK_SIDE}^2: max relative difference {rel}")
    a, b = (t.to(dev) for t in pair(SIZE, 811))

    def body():
        with torch.inference_mode():
            return _diffmap(a, b, 0.8, 1.0, 80.0)

    ms = cuda_ms(body, 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dm, ops = torch_ops(body)
    torch.cuda.synchronize()
    return {"check_side": DIFFMAP_CHECK_SIDE, "max_rel": rel,
            "score_card": float(card.max()), "score_twin": float(
                twin.max()), "side": SIZE, "ms": ms, "torch_ops": ops,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "score": float(dm.max())}


def check_trial_tail(tail_args):
    """render_tail on the e7 trial's own inputs (its first round's call,
    out="xyb") against render_tail_plain at tail_tol, timed beside it."""
    import torch

    from libjxl_tpu_torch.ops import kernels, pipeline

    args, kw = tail_args
    xyb, gab, isg, sad = args[:4]
    epf = args[5]
    got = kernels.render_tail(*args, **kw)
    ref = pipeline.render_tail_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max_err(got, ref)
    check(kw.get("out") == "xyb" and torch.allclose(got, ref,
                                                    **tail_tol(epf)),
          f"render_tail on the e7 trial's inputs disagrees with "
          f"render_tail_plain: max abs err {err}")
    return {"shape": list(xyb.shape), "epf_iters": epf, "max_abs_err": err,
            "ms": cuda_ms(lambda: kernels.render_tail(*args, **kw), 10),
            "plain_ms": cuda_ms(lambda: pipeline.render_tail_plain(
                *args, **kw), 3),
            **bound(*tail_work(xyb[None], isg, sad, gab,
                               pipeline.EPF_CHAINS[epf], "xyb"))}


def _first_input_shape(spec):
    """The shape of the first input in a program's spec."""
    if spec[0] == "input":
        return spec[1]
    if spec[0] in ("tuple", "list", "dict"):
        for v in spec[1]:
            shape = _first_input_shape(v[1] if spec[0] == "dict" else v)
            if shape is not None:
                return shape
    return None


def heuristics_programs(dev, side):
    """{(name, key): program} of the encoder heuristics' programs of `dev`
    on a side^2 frame, from the programs cache."""
    from libjxl_tpu_torch.ops import programs

    first = {"tile_cost": (3, side, side), "diffmap": (3, side, side),
             "trial": (3, side // 8, side // 8, 8, 8)}
    return {(p.name, p.key): p for p in programs.programs(dev)
            if p.name in first
            and _first_input_shape(p.spec) == first[p.name]}


class RunLog:
    """While installed, the (name, key) of every programs.run call on the
    card, in order; with eager=True it first drops the card's cached
    programs, so that every call runs eagerly (the eager route)."""

    def __init__(self, dev, eager=False):
        self.dev, self.eager, self.calls, self.orig = dev, eager, [], None

    def __enter__(self):
        import torch

        from libjxl_tpu_torch.ops import programs

        self.orig = run = programs.run

        def logged(name, key, fn, *args, **kw):
            if torch.device(kw["device"]).type == "cuda":
                self.calls.append((name, key))
                if self.eager:
                    programs.clear(self.dev)
            return run(name, key, fn, *args, **kw)

        programs.run = logged
        return self

    def __exit__(self, *exc):
        from libjxl_tpu_torch.ops import programs

        programs.run = self.orig


def drive_heuristics(dev, smi):
    """The encoder heuristics on the card (the AC-strategy tile costs at
    e >= 4, the e7 refinement's trial through render_tail and its
    diffmap), each a program (ops/programs.py): codestream.encode_lossy(...,
    device=dev) of 2 x SIZE^2 d1 photos at e5 and one at e7, each counted
    (no launch at e5, render_tail once a refinement round at e7), the e5
    ones beside the host encode (device=None) of the same image (bytes
    equal), the e7 one beside it at E7_HOST_SIDE^2; the second e5 encode
    captures the tile sizes the first ran eagerly, the e7 encode's second
    round the trial and the diffmap; the e7 image encoded again (every
    program replays: bytes equal) and on the eager route (every program
    call eager: bytes equal); which programs the e7 encode cycles through,
    what each holds and whether the cache kept them all; the strategy
    blocks that differ from the host encode's; each card stream decoded
    by the host and on the card (within 1 u8 step); the split of one e5
    and one e7 encode; the tile costs (check_tile_costs), the diffmap
    (check_diffmap) and the trial's render_tail (check_trial_tail) against
    their CPU twins. Returns (the trial's render_tail record, the phase's
    record)."""
    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.ops import programs

    codestream.encode_lossy(make_image(256, 256, 809), effort=7,
                            device=dev)  # first torch calls on the card
    runs = []
    modes = {}
    with HeuristicsSpy() as spy:
        jobs = [(SIZE, seed, 5) for seed in HEUR_E5_SEEDS] \
            + [(SIZE, HEUR_E7_SEED, 7)]
        for side, seed, effort in jobs:
            img = make_image(side, side, seed)
            with RunLog(dev) as ran:
                data, secs, strat, n, split = encode_timed(img, effort, dev,
                                                           spy)
            want = {"render_tail": E7_ROUNDS} if effort >= 7 else {}
            check(n == want, f"e{effort} {side}^2 encode on the card "
                  f"launched {n}, not {want}")
            progs = heuristics_programs(dev, SIZE)
            modes[f"e{effort} seed {seed}"] = {
                f"{name} {key}": progs[name, key].mode
                if (name, key) in progs else "dropped"
                for name, key in dict.fromkeys(ran.calls)}
            runs.append({"image": f"{side}^2 d1/e{effort}", "effort": effort,
                         "bytes": len(data), "device_s": secs,
                         "launches": n, "split_ms": split, "img": img,
                         "data": data, "strategy": strat})
        # the second e5 encode captured every tile size the first ran; the
        # e7 encode's second round captured the trial and the diffmap
        e5_sizes = modes[f"e5 seed {HEUR_E5_SEEDS[1]}"]
        check(all(m == "replay" for m in e5_sizes.values()),
              f"the second {SIZE}^2 e5 encode left its programs {e5_sizes}")
        e7_modes = modes[f"e7 seed {HEUR_E7_SEED}"]
        refine = [m for k, m in e7_modes.items()
                  if k.split()[0] in ("trial", "diffmap")]
        check(refine == ["replay", "replay"],
              f"the {SIZE}^2 e7 encode left its programs {e7_modes}")
        e7 = runs[-1]
        img = e7["img"]
        # the same image again: every program of the encode replays
        with RunLog(dev) as ran:
            again, again_s, _, n, again_split = encode_timed(img, 7, dev, spy)
        progs = heuristics_programs(dev, SIZE)
        called = list(dict.fromkeys(ran.calls))
        dropped = [c for c in called if c not in progs]
        check(n == {"render_tail": E7_ROUNDS} and again == e7["data"]
              and not dropped and all(progs[c].mode == "replay"
                                      and progs[c].calls >= 2
                                      for c in called),
              f"the {SIZE}^2 e7 encode again: launches {n}, bytes "
              f"{'equal' if again == e7['data'] else 'differ'}, dropped "
              f"{dropped}, modes "
              f"{[progs[c].mode for c in called if c in progs]}")
        held = {f"{name} {key}": progs[name, key].held / 1e9
                for name, key in called}
        total = sum(p.held for p in programs.programs(dev)) / 1e9
        limit = programs.held_limit(dev) / 1e9
        # the eager route: every program call runs eagerly
        with RunLog(dev, eager=True):
            eager, eager_s, _, n, eager_split = encode_timed(img, 7, dev, spy)
        check(n == {"render_tail": E7_ROUNDS} and eager == e7["data"],
              f"the {SIZE}^2 e7 encode on the eager route: launches {n}, "
              f"bytes {'equal' if eager == e7['data'] else 'differ'}")
        e7_programs = {
            "programs": len(called), "tile_sizes": sum(
                name == "tile_cost" for name, _ in called),
            "modes_after_each_encode": modes, "again_s": again_s,
            "again_split_ms": again_split, "eager_s": eager_s,
            "eager_split_ms": eager_split, "bytes_equal": True,
            "held_gb": held, "held_gb_e7": sum(held.values()),
            "held_gb_all_programs": total, "held_limit_gb": limit,
            "dropped": dropped, "cache_size": programs.CACHE_SIZE}
        log(f"heuristics programs: the {SIZE}^2 e7 encode cycles through "
            f"{len(called)} programs ({e7_programs['tile_sizes']} tile "
            f"sizes, the trial, the diffmap); again, every one replayed: "
            f"{again_s:.3f} s beside {e7['device_s']:.3f} s at its first "
            f"call and {eager_s:.3f} s on the eager route, bytes equal; "
            f"they hold {sum(held.values()):.3f} GB ("
            + ", ".join(f"{k} {v:.3f}" for k, v in held.items())
            + f"), all programs of the card {total:.3f} GB of the "
            f"{limit:.3f} GB bound, none dropped; {smi}")
        img = make_image(E7_HOST_SIDE, E7_HOST_SIDE, HEUR_E7_SEED)
        data, secs, strat, n, split = encode_timed(img, 7, dev, spy)
        check(n == {"render_tail": E7_ROUNDS}, f"e7 {E7_HOST_SIDE}^2 "
              f"encode on the card launched {n}")
        runs.append({"image": f"{E7_HOST_SIDE}^2 d1/e7", "effort": 7,
                     "bytes": len(data), "device_s": secs, "launches": n,
                     "split_ms": split, "img": img, "data": data,
                     "strategy": strat})
        acs_inputs, tail_args = spy.acs_inputs, spy.tail_args
    for run in runs:
        img = run.pop("img")
        data, strat = run.pop("data"), run.pop("strategy")
        out = codestream.decode(data, device=dev)[0]
        near_host(out, codestream.decode(data, device=None)[0],
                  f"{run['image']} card stream: decode(device) vs host")
        err = float(np.abs(out.astype(int) - img.astype(int)).mean())
        check(err < 8.0, f"{run['image']} card stream: mean abs error {err}")
        run["mean_abs_err"] = err
        if run["image"] == f"{SIZE}^2 d1/e7":
            continue
        host, secs, host_strat, _, _ = encode_timed(img, run["effort"], None)
        side = img.shape[0]
        run.update({"host_bytes": len(host), "host_s": secs,
                    "size_ratio": run["bytes"] / len(host),
                    "bytes_equal": host == data,
                    "strategy_blocks_differ": int((strat != host_strat)
                                                  .sum()),
                    "blocks": int(strat.size),
                    "device_mp_s": mp_s(side * side, run["device_s"]),
                    "host_mp_s": mp_s(side * side, secs)})
        if run["effort"] == 5:
            check(run["bytes_equal"], f"{run['image']} card stream: "
                  f"{run['bytes']} bytes unlike the host encode's "
                  f"{len(host)}")
    tiles = check_tile_costs(acs_inputs, dev)
    diffmap = check_diffmap(dev)
    trial = {"launches": runs[2]["launches"]["render_tail"],
             **check_trial_tail(tail_args)}
    rec = {"encodes": runs, "tile_cost": tiles, "diffmap": diffmap,
           "trial_render_tail": trial, "e7_programs": e7_programs}
    for run in runs:
        log(f"heuristics encode {run['image']}: card {run['bytes']} B in "
            f"{run['device_s']:.3f} s"
            + (f" ({run['device_mp_s']:.2f} MP/s) beside the host "
               f"{run['host_bytes']} B in {run['host_s']:.3f} s "
               f"({run['host_mp_s']:.2f} MP/s), size ratio "
               f"{run['size_ratio']:.5f}, bytes "
               f"{'equal' if run['bytes_equal'] else 'differ'}, "
               f"{run['strategy_blocks_differ']} of {run['blocks']} "
               "strategy blocks differ" if "host_s" in run else "")
            + f"; launches {run['launches']}; split (ms) " + ", ".join(
                f"{k} {v:.1f}" for k, v in run["split_ms"].items())
            + f"; decoded mean abs error {run['mean_abs_err']:.3f}")
    log(f"heuristics tile costs on {tiles['image']} (card vs CPU twin; card "
        "ms by CUDA events, twin and host numpy by host clock): " + "; ".join(
            f"{k} max rel {v['max_rel']:.2e} ({v['off']} of {v['tiles']} "
            f"tiles off), {v['ms']:.3f} ms vs twin {v['twin_ms']:.1f} ms, "
            f"host {v['host_ms']:.1f} ms"
            for k, v in tiles["sizes"].items())
        + f"; the search from the card's costs and the twin's: "
        f"{tiles['strategy_blocks_differ']} of {tiles['blocks']} strategy "
        "blocks differ")
    log(f"heuristics diffmap: card vs CPU twin at {DIFFMAP_CHECK_SIDE}^2 max "
        f"rel {diffmap['max_rel']:.2e} (bound {DIFFMAP_REL}); at {SIZE}^2 "
        f"{diffmap['ms']:.3f} ms (CUDA events), peak device memory "
        f"{diffmap['peak_gb']:.3f} GB, {diffmap['torch_ops']} torch "
        "operations a diffmap")
    log(f"heuristics trial render_tail ({trial['shape']}, epf "
        f"{trial['epf_iters']}): max abs err {trial['max_abs_err']:.3g}, "
        f"{trial['ms']:.4f} ms vs plain {trial['plain_ms']:.4f} ms, bound "
        f"{trial['bound_ms']:.4f} ms ({trial['bound_by']}); launches "
        f"{trial['launches']} over the e7 encode; {smi}")
    return trial, rec


# The multi-device phase (drive_sharded): a mesh of SHARDS entries, the
# cards in turn, so one card gives four entries of cuda:0 (a virtual mesh);
# ONE big image strip-sharded over them, at the JAX dry run's default 64 MP
SHARDS = 4
SHARD_BIG = 8192
SHARD_SEED = 900
SHARD_LAUNCHES = {"dequant_idct8": SHARDS, "render_tail": SHARDS}


class KernelSpy:
    """While installed, kernels.dequant_idct8 and kernels.render_tail keep
    the (args, kwargs) of their call number `keep` (from 0) in `calls`,
    and launch as before: one shard's own inputs, to time its launches
    and hold them to the twins afterwards."""

    NAMES = ("dequant_idct8", "render_tail")

    def __init__(self, keep):
        self.keep, self.calls, self.seen, self.orig = keep, {}, {}, {}

    def __enter__(self):
        from libjxl_tpu_torch.ops import kernels

        for name in self.NAMES:
            fn = self.orig[name] = getattr(kernels, name)

            def spy(*args, _name=name, _fn=fn, **kw):
                i = self.seen.get(_name, 0)
                self.seen[_name] = i + 1
                if i == self.keep:
                    self.calls[_name] = (args, kw)
                return _fn(*args, **kw)

            setattr(kernels, name, spy)
        return self

    def __exit__(self, *exc):
        from libjxl_tpu_torch.ops import kernels

        for name, fn in self.orig.items():
            setattr(kernels, name, fn)


def peak_gb(fn, devices):
    """The device memory fn() allocates at its peak above what was
    allocated before it, in GB, summed over the cards among `devices`."""
    import torch

    cards = sorted({d.index for d in devices})
    base = {}
    for i in cards:
        torch.cuda.synchronize(i)
        base[i] = torch.cuda.memory_allocated(i)
        torch.cuda.reset_peak_memory_stats(i)
    fn()
    for i in cards:
        torch.cuda.synchronize(i)
    return sum(torch.cuda.max_memory_allocated(i) - base[i]
               for i in cards) / 1e9


def check_shard_kernels(spy):
    """dequant_idct8 and render_tail on one call's own inputs (`spy`'s
    call: a shard's, or a route's) against their twins, timed beside
    them on the inputs' own card (its events, its synchronize); the
    records' "sharded" entries without launches (u8 steps where the call
    wrote u8)."""
    import torch

    from libjxl_tpu_torch.ops import kernels, pipeline

    k1_args, _ = spy.calls["dequant_idct8"]
    with torch.cuda.device(k1_args[0].device):
        got = kernels.dequant_idct8(*k1_args)
        ref = pipeline.decode_xyb_image(*k1_args)
        torch.cuda.synchronize()
        k1_err = max_err(got, ref)
        check(torch.allclose(got, ref, **K1_TOL), "a shard's dequant_idct8 "
              f"disagrees with decode_xyb_image: max abs err {k1_err}")
        del got, ref
        q = k1_args[0]
        k1 = {"shard": "x".join(map(str, q.shape[-2:][::-1])),
              "max_abs_err": k1_err,
              "ms_per_shard": cuda_ms(
                  lambda: kernels.dequant_idct8(*k1_args), 10),
              "plain_ms": cuda_ms(
                  lambda: pipeline.decode_xyb_image(*k1_args), 3),
              **bound(tensor_bytes(*k1_args[:7]) + 4 * q.numel(),
                      K1_OPS * q.numel())}

    t_args, t_kw = spy.calls["render_tail"]
    with torch.cuda.device(t_args[0].device):
        comp, gab, isg, sad, _, iters = t_args[:6]
        got = kernels.render_tail(*t_args, out="xyb")
        ref = pipeline.render_tail_plain(*t_args, out="xyb")
        torch.cuda.synchronize()
        k2_err = max_err(got, ref)
        check(torch.allclose(got, ref, **tail_tol(iters)),
              "a shard's render_tail (XYB) disagrees with its twin: max abs "
              f"err {k2_err}")
        del got, ref
        steps = None
        if t_kw.get("out") == "u8srgb":
            got = kernels.render_tail(*t_args, **t_kw)
            ref = pipeline.render_tail_plain(*t_args, **t_kw)
            torch.cuda.synchronize()
            steps = int((got.int() - ref.int()).abs().max())
            check(steps <= U8_BOUND, f"a shard's render_tail (u8) is "
                  f"{steps} steps from its twin")
            del got, ref
        k2 = {"shard": "x".join(map(str, comp.shape[-2:][::-1])),
              "max_abs_err": k2_err, "u8_max_steps": steps,
              "ms_per_shard": cuda_ms(
                  lambda: kernels.render_tail(*t_args, **t_kw), 10),
              "plain_ms": cuda_ms(
                  lambda: pipeline.render_tail_plain(*t_args, **t_kw), 3),
              **bound(*tail_work(comp[None], isg, sad, gab,
                                 pipeline.EPF_CHAINS[iters], t_kw["out"]))}
    return {"dequant_idct8": k1, "render_tail": k2}


def replays_equal(run, args, first, want, label, devices, mine):
    """run(*args) twice after its eager first call, which gave `first`:
    the capture and a replay of the builder's programs (those of `devices`
    that mine(program) admits), each counted (`want`) and bitwise equal
    to the first call; every such program then replays. Returns the host
    seconds of the replayed call."""
    from libjxl_tpu_torch.base.device import reset_launch_counts
    from libjxl_tpu_torch.ops import programs
    from libjxl_tpu_torch.parallel.sharding import synchronize

    for what in ("capture", "replay"):
        synchronize(devices)
        reset_launch_counts()
        t = time.perf_counter()
        got = run(*args)
        synchronize(devices)
        secs = time.perf_counter() - t
        n = nonzero_counts()
        check(n == want, f"{label} ({what}): launches {n}, not {want}")
        check(_same(got, first), f"{label}: the {what} differs from the "
              "eager call")
    progs = [p for d in set(devices) for p in programs.programs(d)
             if mine(p)]
    check(progs and all(p.mode == "replay" for p in progs),
          f"{label}: programs {[(p.key, p.mode) for p in progs]}")
    return secs


def named(name):
    return lambda p: p.name == name


def drive_builders(devices, dev):
    """build_sharded_decode_full and build_sharded_encode on a (batch 2,
    rows 2) mesh of `devices` at 2048^2, counted, against the unsharded
    port forms on the card: dequant_idct8 + render_tail + xyb_to_rgb over
    the whole batch (within tail_tol, likely equal), encode_coefficients
    image by image (equal)."""
    import torch

    from libjxl_tpu_torch.base.device import reset_launch_counts
    from libjxl_tpu_torch.ops import kernels, pipeline
    from libjxl_tpu_torch.ops.staging import to_device
    from libjxl_tpu_torch.parallel import sharding
    from libjxl_tpu_torch.render.pipeline import _sad_mul_map
    from libjxl_tpu_torch.vardct.quant_weights import DequantMatrices

    mesh = sharding.make_mesh(devices, batch=2)
    rng = np.random.default_rng(SHARD_SEED + 1)
    b, h, w = 2, SIZE, SIZE
    nby, nbx = h // 8, w // 8
    m = DequantMatrices()
    dm = np.stack([m.dequant_matrix(0, c) for c in range(3)]).astype(
        np.float32)
    dm_inv = np.stack([m.inv_matrix(0, c) for c in range(3)]).astype(
        np.float32)
    isg = rng.uniform(-2.5, -0.3, (b, nby, nbx)).astype(np.float32)
    args = to_device((
        (rng.integers(-3, 4, (b, 3, h, w))
         * (rng.random((b, 3, h, w)) < 0.1)).astype(np.int32),
        rng.integers(2, 30, (b, nby, nbx)).astype(np.int32),
        rng.normal(0, 0.2, (b, 3, nby, nbx)).astype(np.float32),
        rng.integers(-10, 10, (b, nby // 8, nbx // 8)).astype(np.int32),
        rng.integers(-45, -30, (b, nby // 8, nbx // 8)).astype(np.int32),
        dm, np.repeat(np.repeat(isg, 8, 1), 8, 2),
        _sad_mul_map(h, w, 2.0 / 3.0).astype(np.float32)), dev)
    full = sharding.build_sharded_decode_full(mesh, epf_iters=2)
    reset_launch_counts()
    got = full(*args)
    torch.cuda.synchronize()
    launches = nonzero_counts()
    check(launches == SHARD_LAUNCHES, f"build_sharded_decode_full "
          f"launches {launches}")
    replays_equal(full, args, got, SHARD_LAUNCHES,
                  "build_sharded_decode_full", devices,
                  named("sharded_full"))
    gab = to_device(sharding.GAB_KERNELS, dev)

    def unsharded():
        xyb = kernels.dequant_idct8(*args[:6], torch.full(
            (b,), 1024.0, device=dev), 1.0, 1.0)
        return pipeline.xyb_to_rgb(kernels.render_tail(
            xyb, gab, to_device(isg, dev), args[7],
            sharding.FULL_CHANNEL_SCALE, 2, out="xyb"))

    ref = unsharded()
    torch.cuda.synchronize()
    full_err = max_err(got, ref)
    check(torch.allclose(got, ref, **tail_tol(2)), "build_sharded_decode_"
          f"full disagrees with the unsharded forms: max abs err {full_err}")
    rec = {"mesh": repr(mesh), "full": {
        "launches": launches, "max_abs_err": full_err,
        "equal": bool(torch.equal(got, ref)),
        "ms": cuda_ms(lambda: full(*args), 3),
        "unsharded_ms": cuda_ms(unsharded, 3)}}
    del got, ref, args

    rgb = pipeline.srgb2lin(torch.from_numpy(np.stack([
        np.moveaxis(make_image(h, w, SHARD_SEED + 2 + i), -1, 0)
        for i in range(b)]).astype(np.float32) / 255.0).to(dev))
    qf = to_device(rng.integers(32, 96, (b, nby, nbx)).astype(np.int32), dev)
    consts = to_device((dm_inv, dm[1], np.array([512.0, 64.0, 32.0],
                                                dtype=np.float32)), dev)
    enc = sharding.build_sharded_encode(mesh)
    reset_launch_counts()
    q, qdc = enc(rgb, qf, consts[0], consts[1], consts[2])
    torch.cuda.synchronize()
    check(nonzero_counts() == {}, "the sharded encode launched a kernel")
    replays_equal(enc, (rgb, qf, *consts), (q, qdc), {},
                  "build_sharded_encode", devices, named("sharded_encode"))
    ref = [pipeline.encode_coefficients(rgb[i], qf[i], consts[0], consts[1],
                                        1024.0, 1.0, 1.0, consts[2])
           for i in range(b)]
    differ = [int((q != torch.stack([r[0] for r in ref])).sum()),
              int((qdc != torch.stack([r[1] for r in ref])).sum())]
    check(differ == [0, 0], f"build_sharded_encode differs from "
          f"encode_coefficients in {differ} (q, qdc) values")
    rec["encode"] = {"differ": differ, "of": [q.numel(), qdc.numel()],
                     "ms": cuda_ms(lambda: enc(rgb, qf, *consts), 3)}
    return rec


def drive_sharded(main16, piped16, big, big_bytes, dev, smi):
    """The multi-device path on a mesh of SHARDS entries (the cards in
    turn; on one card a virtual mesh of cuda:0), each driven with the
    counters reset just before: tpu_codec.decode_batch_sharded of the 16
    main 2048^2 streams (equal to decode_pipelined's, one dequant_idct8
    and one render_tail a shard; host clock beside decode_batch's); ONE
    SHARD_BIG^2 d1/e3 photo encoded on the card, entropy-decoded on the
    host and rendered strip-sharded with build_sharded_decode_stream
    over SHARDS row bands against the whole-image render (equal, or the
    gate: 1 step, under 1e-3 of the values), the three timed by CUDA
    events on device-resident inputs with their peak device memory, and
    both kernels on the second band's own inputs against their twins;
    the BIG^2 streaming encode with the mesh (bytes equal to hosts=1's,
    no launch); drive_builders. Returns ({kernel: its "sharded" record},
    the phase's record)."""
    import torch

    from libjxl_tpu_torch.api import codestream, tpu_codec
    from libjxl_tpu_torch.base.device import reset_launch_counts
    from libjxl_tpu_torch.parallel import dryrun, sharding

    devices = dryrun.mesh_devices(SHARDS, "cuda")
    virtual = len(set(devices)) < len(devices)
    mesh = sharding.make_mesh(devices)
    log(f"phase sharded: {mesh!r}; " + (
        "a VIRTUAL mesh (its entries repeat a card): its times measure the "
        "shard bookkeeping and the extra launches, not scaling"
        if virtual else f"{torch.cuda.device_count()} cards"))
    rec = {"mesh": repr(mesh), "virtual": virtual,
           "cards": torch.cuda.device_count()}

    peer = {f"{a}->{b}": torch.cuda.can_device_access_peer(a.index,
                                                           b.index)
            for a in dict.fromkeys(devices) for b in dict.fromkeys(devices)
            if a != b}
    rec["peer_access"] = peer or None
    log("phase sharded: halo rows move " + (
        "within one card (no peer copy)" if not peer else
        "between cards by peer copy where " + json.dumps(peer) + " says "
        "true, through the host where false"))

    reset_launch_counts()
    t = time.perf_counter()
    outs = tpu_codec.decode_batch_sharded(main16, mesh)
    serve_s = time.perf_counter() - t
    launches = nonzero_counts()
    check(launches == SHARD_LAUNCHES,
          f"decode_batch_sharded launches {launches}")
    per = len(main16) // SHARDS
    serve_replay_s = replays_equal(
        lambda: tpu_codec.decode_batch_sharded(main16, mesh), (), outs,
        SHARD_LAUNCHES, "decode_batch_sharded", devices,
        lambda p: p.name == "batch"
        and _first_input_shape(p.spec)[0] == per)
    t = time.perf_counter()
    same = tpu_codec.decode_batch(main16, dev)
    batch_s = time.perf_counter() - t
    for a, b, c in zip(outs, piped16, same):
        check(np.array_equal(a, b) and np.array_equal(a, c),
              "decode_batch_sharded differs from decode_batch")
    mp = len(main16) * SIZE * SIZE
    rec["serving"] = {"launches": launches, "secs": serve_s,
                      "mp_s": mp_s(mp, serve_s), "replay_secs":
                      serve_replay_s, "batch_secs": batch_s,
                      "batch_mp_s": mp_s(mp, batch_s)}
    log(f"phase sharded serving decode ({len(main16)} x {SIZE}^2 over "
        f"{SHARDS} shards, host clock): {serve_s:.3f} s "
        f"({mp_s(mp, serve_s):.2f} MP/s; replayed {serve_replay_s:.3f} s) "
        f"beside decode_batch's "
        f"{batch_s:.3f} s "
        f"({mp_s(mp, batch_s):.2f} MP/s); equal to decode_pipelined's")

    img = make_image(SHARD_BIG, SHARD_BIG, SHARD_SEED)
    t = time.perf_counter()
    stream = codestream.encode_lossy(img, distance=1.0, effort=3, device=dev)
    enc_s = time.perf_counter() - t
    del img
    t = time.perf_counter()
    sr = dryrun.StreamRender.of(stream, num_threads=os.cpu_count() or 1)
    entropy_s = time.perf_counter() - t
    sr = sr.on(dev)
    whole = sr.single(dev)
    run1 = sr.sharded(sharding.make_mesh(devices[:1]))
    run = sr.sharded(mesh)
    with KernelSpy(keep=1) as spy, torch.inference_mode():
        reset_launch_counts()
        got = run(*sr.args)
        torch.cuda.synchronize()
        launches = nonzero_counts()
    check(launches == SHARD_LAUNCHES,
          f"build_sharded_decode_stream launches {launches}")
    band = replays_equal(run, sr.args, got, SHARD_LAUNCHES,
                         "the band program", devices,
                         lambda p: p.name == "sharded_stream"
                         and p.key[-1][1] < SHARDS)
    got = got.permute(1, 2, 0)
    equal = bool(torch.equal(got, whole))
    steps, frac = dryrun.u8_steps(got.cpu().numpy(), whole.cpu().numpy(),
                                  "the strip-sharded big image")
    del got
    with torch.inference_mode():
        one = run1(*sr.args)
        check(torch.equal(one.permute(1, 2, 0), whole), "the band program "
              "on a 1-entry mesh differs from the whole-image render")
    replays_equal(run1, sr.args, one, RENDER_LAUNCHES,
                  "the band program on a 1-entry mesh", devices[:1],
                  lambda p: p.name == "sharded_stream"
                  and p.key[-1] == (0, 0))
    del one

    def eager(builder):
        """builder(*sr.args) on the eager route: its programs dropped
        first, so that each runs its first, eager call."""
        from libjxl_tpu_torch.ops import programs

        for d in dict.fromkeys(devices):
            programs.clear(d)
        return builder(*sr.args)

    with torch.inference_mode():
        ms = {"whole": cuda_ms(lambda: sr.single(dev), 3),
              "strips_1": cuda_ms(lambda: run1(*sr.args), 3),
              f"strips_{SHARDS}": cuda_ms(lambda: run(*sr.args), 3)}
        peak = {"whole": peak_gb(lambda: sr.single(dev), [dev]),
                "strips_1": peak_gb(lambda: run1(*sr.args), devices[:1]),
                f"strips_{SHARDS}": peak_gb(lambda: run(*sr.args),
                                            devices)}
        ms["strips_1_eager"] = cuda_ms(lambda: eager(run1), 3)
        ms[f"strips_{SHARDS}_eager"] = cuda_ms(lambda: eager(run), 3)
    kernels = check_shard_kernels(spy)
    del spy, sr, whole
    rec["big"] = {"image": f"{SHARD_BIG}^2 d1/e3, device-encoded",
                  "bands": SHARDS, "launches": launches, "equal": equal,
                  "replay_host_s": band,
                  "steps": steps, "fraction": frac, "encode_s": enc_s,
                  "entropy_s": entropy_s, "ms": ms, "peak_gb": peak}
    log(f"phase sharded big image ({rec['big']['image']}, {SHARDS} bands of "
        f"{SHARD_BIG // SHARDS} rows): "
        + ("equal to" if equal else f"{steps} step(s), {frac:.2e} of values "
           "off") + " the whole-image render; render (CUDA events, "
        "device-resident inputs; the band programs replayed, or eager "
        "where named): " + ", ".join(
            f"{k} {v:.4f} ms" + (f" ({peak[k]:.3f} GB peak above the "
                                 "inputs)" if k in peak else "")
            for k, v in ms.items())
        + f"; a band: " + ", ".join(
            f"{k} {v['ms_per_shard']:.4f} ms (plain {v['plain_ms']:.4f}, "
            f"bound {v['bound_ms']:.4f}, {v['shard']})"
            for k, v in kernels.items())
        + f"; encode {enc_s:.3f} s, host entropy {entropy_s:.3f} s; {smi}")

    reset_launch_counts()
    t = time.perf_counter()
    data = codestream.encode_lossy_streaming(big, distance=1.0, mesh=mesh,
                                             device=dev)
    stream_s = time.perf_counter() - t
    check(nonzero_counts() == {}, "the sharded streaming encode launched a "
          "kernel")
    check(data == big_bytes, f"the streaming encode with the mesh wrote "
          f"{len(data)} bytes unlike hosts=1's {len(big_bytes)}")
    from libjxl_tpu_torch.ops import programs

    # one call of each entry's program a DC group (2048^2): the first
    # eager, the second captures, the rest replay
    groups = -(-big.shape[0] // 2048) * -(-big.shape[1] // 2048)
    chunk = [p for d in dict.fromkeys(devices) for p in programs.programs(d)
             if p.name == "sharded_chunk"]
    check(len(chunk) == SHARDS and all(
        p.calls == groups and (groups < 2 or p.mode == "replay")
        for p in chunk), f"the sharded chunk step's programs over {groups} "
        "DC groups: " + repr([(p.key, p.mode, p.calls) for p in chunk]))
    mp = big.shape[0] * big.shape[1]
    rec["streaming"] = {"secs": stream_s, "mp_s": mp_s(mp, stream_s),
                        "bytes_equal": True}
    log(f"phase sharded streaming encode ({BIG}^2, mesh of {SHARDS}, host "
        f"clock): {stream_s:.3f} s ({mp_s(mp, stream_s):.2f} MP/s), bytes "
        "equal to hosts=1's")

    rec["builders"] = drive_builders(devices, dev)
    b = rec["builders"]
    log(f"phase sharded builders ({b['mesh']}, 2 x {SIZE}^2): full decode "
        f"{'equal to' if b['full']['equal'] else 'within tail_tol of'} the "
        f"unsharded forms (max abs err {b['full']['max_abs_err']:.3g}), "
        f"{b['full']['ms']:.4f} ms vs {b['full']['unsharded_ms']:.4f} ms; "
        f"encode equal to encode_coefficients, {b['encode']['ms']:.4f} ms "
        f"(CUDA events); {smi}")
    for name, k in kernels.items():
        k["launches"] = SHARDS
    return kernels, rec


# The user entry points (drive_tools): the port's CLIs (libjxl_tpu_torch/
# tools) through their main(argv) in this process, and its Decoder and
# Encoder, on the card. The JPEG photo and its host work (the recompression
# and the reconstruction, both host code) run in a worker process beside
# the phase's card work; the benchmark row is taken at BENCH_SIDE^2, since
# the tool's host metrics (butteraugli twice, MS-SSIM, SSIMULACRA 2, all
# NumPy) take ~70 s at 2048^2
TOOLS_SEED = 1000  # the cjxl photo
LOWMEM_STRIPS = 16  # BIG^2 in 256-row strips
JPEG_SIDE, JPEG_SEED = 2048, 1010
BENCH_SIDE, BENCH_SEED = 1024, 1020
ANIM_SIDE, ANIM_SEEDS = 1024, (1030, 1031)
DECODER_CHUNKS = 4


def tool_main(tool, argv):
    """tool.main(argv) in this process, the launch counters set to 0 just
    before and read just after: (host seconds, launches, standard output,
    standard error). Raises unless it returns 0."""
    import contextlib
    import io

    from libjxl_tpu_torch.base.device import reset_launch_counts

    out, err = io.StringIO(), io.StringIO()
    argv = [str(a) for a in argv]
    reset_launch_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tool.main(argv)
    secs = time.perf_counter() - t
    n = nonzero_counts()
    check(rc == 0, f"{tool.__name__.rsplit('.', 1)[-1]} {' '.join(argv)}: "
          f"exit code {rc}: {err.getvalue()[-800:]}")
    return secs, n, out.getvalue(), err.getvalue()


def jpeg_tool_job(job):
    """Worker process (spawn): the host half of the tools' JPEG path. A
    side^2 4:2:0 JPEG of make_image by jpegli.encode_jpegli; `cjxl in.jpg
    out.jxl` (the VarDCT recompression); `djxl out.jxl back.jpg`, which
    must give back the JPEG's bytes; the host decode of the recompressed
    codestream, the reference of the card's render. Both tools through
    main(argv), in a temporary directory; neither may launch a kernel.
    Returns (record, jpeg bytes, recompressed bytes, host u8)."""
    import tempfile

    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.io.container import extract_codestream
    from libjxl_tpu_torch.jpegli import encode_jpegli
    from libjxl_tpu_torch.tools import cjxl, djxl

    side, seed = job
    rec = {"image": f"{side}^2 4:2:0 JPEG (jpegli d1)"}
    with tempfile.TemporaryDirectory() as tmp:
        src, jxl = os.path.join(tmp, "in.jpg"), os.path.join(tmp, "out.jxl")
        back = os.path.join(tmp, "back.jpg")
        t = time.perf_counter()
        jpg = encode_jpegli(make_image(side, side, seed), distance=1.0,
                            subsampling="420")
        rec["jpegli_s"] = time.perf_counter() - t
        with open(src, "wb") as f:
            f.write(jpg)
        rec["cjxl_s"], n, _, _ = tool_main(cjxl, [src, jxl])
        check(n == {}, f"cjxl of a JPEG launched {n}")
        rec["djxl_jpg_s"], n, _, _ = tool_main(djxl, [jxl, back])
        check(n == {}, f"djxl to .jpg launched {n}")
        with open(jxl, "rb") as f:
            data = f.read()
        with open(back, "rb") as f:
            check(f.read() == jpg, f"djxl {side}^2: the reconstructed JPEG "
                  "differs from the original")
    t = time.perf_counter()
    ref = codestream.decode(extract_codestream(data), device=None)[0]
    rec["host_decode_s"] = time.perf_counter() - t
    rec.update(jpeg_bytes=len(jpg), jxl_bytes=len(data),
               reconstruction="exact")
    return rec, jpg, data, ref


def drive_tools(e5, big, dev, smi):
    """The user entry points on the card, each tool call through its
    main(argv) with the counters reset just before and read just after
    (tool_main), in a temporary directory, PPM/NPY files only:
    djxl on the 2048^2 e5 streams (within 1 u8 step of the host decode,
    one dequant_idct8 and one render_tail a frame, MP/s beside djxl
    --host); djxl --low_memory of the BIG^2 photo at e3 (dequant_idct8
    and render_tail once a strip, rows equal to decode_rows(device)'s);
    cjxl -e 3 (no launch) and -e 7 (render_tail once a refinement round)
    of a 2048^2 photo, bytes against codestream.encode_lossy called with
    cjxl's arguments; the JPEG path (jpeg_tool_job in a worker; then
    `djxl out.jxl out.ppm` on the card, the YCbCr route, within 1 u8 step
    of the host decode) and the corpus pair jpeg_recon.{jpg,jxl}; one
    benchmark row (--codec d1.0) at BENCH_SIDE^2, its decode on the card;
    Encoder(device) bytes against encode_lossy's, Decoder(device) on a
    2048^2 e5 stream in DECODER_CHUNKS pieces (the per-section host
    route, no launch) and on an animation whose second frame blends
    (the whole-stream route through decode on the card). Returns
    (launches of the whole phase, record)."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import tempfile

    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.api import decoder as tdec
    from libjxl_tpu_torch.api import encoder as tenc
    from libjxl_tpu_torch.base.device import reset_launch_counts
    from libjxl_tpu_torch.extras.io import load_image, save_image
    from libjxl_tpu_torch.io.container import extract_codestream
    from libjxl_tpu_torch.tools import benchmark, cjxl, djxl

    root = os.path.dirname(os.path.abspath(__file__))
    corpus_dir = os.path.join(root, "tests", "data", "conformance")
    total = {}

    def add(n):
        for k, v in n.items():
            total[k] = total.get(k, 0) + v

    rec = {}
    with cf.ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as bg, \
            tempfile.TemporaryDirectory() as tmp:
        jpeg_job = bg.submit(jpeg_tool_job, (JPEG_SIDE, JPEG_SEED))

        def path(name):
            return os.path.join(tmp, name)

        # djxl on the e5 streams, on the card and with --host
        runs = []
        for i, (stream, ref) in enumerate(e5):
            src = path(f"e5_{i}.jxl")
            with open(src, "wb") as f:
                f.write(stream)
            secs, n, _, err = tool_main(djxl, [src, path("card.ppm"), "-v"])
            add(n)
            check(n == RENDER_LAUNCHES, f"djxl e5 #{i} launched {n}")
            check("render path: device:u8" in err, f"djxl e5 #{i}: {err}")
            steps, share = near_host(load_image(path("card.ppm")), ref,
                                     f"djxl e5 #{i} on the card")
            host_s, n, _, _ = tool_main(djxl, [src, path("host.ppm"),
                                               "--host"])
            check(n == {} and np.array_equal(load_image(path("host.ppm")),
                                             ref),
                  f"djxl --host e5 #{i}: launches {n} or pixels differ "
                  "from the host decode")
            runs.append({"card_s": secs, "host_s": host_s, "steps": steps,
                         "share_off": share})
        mp_img = SIZE * SIZE
        rec["djxl_e5"] = {
            "image": f"{SIZE}^2 d1/e5", "frames": len(runs),
            "launches_per_frame": RENDER_LAUNCHES,
            "card_mp_s": [mp_s(mp_img, r["card_s"]) for r in runs],
            "host_mp_s": [mp_s(mp_img, r["host_s"]) for r in runs],
            "max_steps": max(r["steps"] for r in runs),
            "max_share_off": max(r["share_off"] for r in runs)}

        # djxl --low_memory of the BIG^2 photo at e3 (seed 600)
        data = codestream.encode_lossy(big, distance=1.0, effort=3,
                                       device=dev)
        with open(path("big.jxl"), "wb") as f:
            f.write(data)
        secs, n, _, err = tool_main(djxl, [path("big.jxl"), path("big.ppm"),
                                           "--low_memory", "-v"])
        add(n)
        want = {"dequant_idct8": LOWMEM_STRIPS, "render_tail": LOWMEM_STRIPS}
        check(n == want, f"djxl --low_memory launched {n}, not {want}")
        check("low-memory on cuda" in err, f"djxl --low_memory: {err}")
        rows = np.concatenate([r for _, r in codestream.decode_rows(
            data, device=dev)], axis=0)
        check(np.array_equal(load_image(path("big.ppm")), rows),
              "djxl --low_memory differs from decode_rows(device)")
        rec["djxl_low_memory"] = {"image": f"{BIG}^2 d1/e3", "launches": n,
                                  "mp_s": mp_s(BIG * BIG, secs)}

        # cjxl at e3 and e7 against encode_lossy with cjxl's arguments
        img = make_image(SIZE, SIZE, TOOLS_SEED)
        save_image(path("photo.ppm"), img)
        rec["cjxl"] = []
        for effort, want in ((3, {}), (7, {"render_tail": E7_ROUNDS})):
            out = path(f"e{effort}.jxl")
            secs, n, _, _ = tool_main(cjxl, [path("photo.ppm"), out, "-e",
                                             effort])
            add(n)
            check(n == want, f"cjxl -e {effort} launched {n}, not {want}")
            t = time.perf_counter()
            direct = codestream.encode_lossy(
                img, distance=1.0, group_size_shift=1, icc=None,
                effort=effort, progressive=1, resampling=1,
                photon_noise_iso=None, preview=None, intensity_target=None,
                iterations=None, already_downsampled=False,
                progressive_dc=False, group_order=0, center_x=None,
                center_y=None, epf=None, gaborish=None, dots=None,
                patches=None, noise=False, stats=None, debug_cb=None,
                device=dev)
            direct_s = time.perf_counter() - t
            with open(out, "rb") as f:
                got = f.read()
            differ = 0
            if got != direct:
                # a near-tie of the card's cost sums can flip a strategy
                differ = int((capture_frame(got)[0].strategy
                              != capture_frame(direct)[0].strategy).sum())
            rec["cjxl"].append({
                "image": f"{SIZE}^2 d1/e{effort}", "launches": n,
                "bytes": len(got), "bytes_equal_direct": got == direct,
                "strategy_blocks_differ": differ,
                "mp_s": mp_s(mp_img, secs),
                "direct_mp_s": mp_s(mp_img, direct_s)})
            near_host(codestream.decode(got, device=dev)[0],
                      codestream.decode(got, device=None)[0],
                      f"cjxl -e {effort} stream decoded on the card")

        # one benchmark row, its decode on the card
        save_image(path("bench.ppm"), make_image(BENCH_SIDE, BENCH_SIDE,
                                                 BENCH_SEED))
        secs, n, out, _ = tool_main(benchmark, [path("bench.ppm"),
                                                "--codec", "d1.0"])
        add(n)
        check(n == RENDER_LAUNCHES, f"benchmark d1.0 launched {n}: its "
              "decode did not run on the card")
        row = json.loads(out.strip().splitlines()[-1])
        log(f"benchmark row ({BENCH_SIDE}^2, card): {json.dumps(row)}")
        check(row["config"] == "d1.0" and row["psnr"] > 30
              and row["butteraugli"] < 3, f"benchmark row {row}")
        rec["benchmark"] = {"image": f"{BENCH_SIDE}^2", "row": row,
                            "launches": n, "tool_s": secs}

        # Encoder(device) against encode_lossy: e3 on the photo, the
        # default e5 on a 512^2 crop of it
        rec["encoder"] = []
        for effort, pixels in ((3, img), (5, img[:512, :512])):
            enc = tenc.Encoder(device=dev)
            fs = enc.frame_settings()
            fs.set_option(tenc.SETTING_EFFORT, effort)
            enc.add_image_frame(fs, pixels)
            reset_launch_counts()
            got = enc.process_output()
            n = nonzero_counts()
            add(n)
            direct = codestream.encode_lossy(pixels, distance=1.0,
                                             effort=effort, device=dev)
            check(got == direct, f"Encoder(device) e{effort} bytes differ "
                  "from encode_lossy's")
            rec["encoder"].append({"side": pixels.shape[0],
                                   "effort": effort, "launches": n,
                                   "bytes": len(got)})

        # Decoder(device): a 2048^2 e5 stream in chunks, then an animation
        # whose second frame blends (the whole-stream route)
        stream, ref = e5[0]

        def feed(dec, data, chunks):
            events = []
            step = -(-len(data) // chunks)
            for k in range(0, len(data), step):
                dec.set_input(data[k:k + step])
                while True:
                    events.append(dec.process())
                    if events[-1] in (tdec.NEED_MORE_INPUT, tdec.FULL_IMAGE,
                                      tdec.SUCCESS):
                        break
                if events[-1] != tdec.NEED_MORE_INPUT:
                    break
            return events

        dec = tdec.Decoder(device=dev)
        reset_launch_counts()
        t = time.perf_counter()
        events = feed(dec, stream, DECODER_CHUNKS)
        secs = time.perf_counter() - t
        n = nonzero_counts()
        check(events[-1] == tdec.FULL_IMAGE and n == {},
              f"Decoder e5: events {events}, launches {n}")
        steps, _ = near_host(dec.image, ref, "Decoder(device) e5 chunks")
        rec["decoder_chunks"] = {"image": f"{SIZE}^2 d1/e5",
                                 "chunks": DECODER_CHUNKS, "events": events,
                                 "launches": n, "steps": steps,
                                 "mp_s": mp_s(mp_img, secs)}
        anim = blend_animation([make_image(ANIM_SIDE, ANIM_SIDE, s)
                                for s in ANIM_SEEDS], dev)
        dec = tdec.Decoder(device=dev)
        reset_launch_counts()
        events = feed(dec, anim, DECODER_CHUNKS)
        n = nonzero_counts()
        add(n)
        check(events[-1] == tdec.FULL_IMAGE and n == RENDER_LAUNCHES,
              f"Decoder, blended animation: events {events}, launches {n}")
        steps, _ = near_host(dec.image, codestream.decode(anim,
                                                          device=None)[0],
                             "Decoder(device), blended animation")
        rec["decoder_whole_stream"] = {
            "image": f"2 x {ANIM_SIDE}^2 animation, the second frame kAdd",
            "events": events, "launches": n, "steps": steps}

        # the corpus pair, then the JPEG photo from the worker
        recon = os.path.join(corpus_dir, "jpeg_recon")
        _, n, _, _ = tool_main(djxl, [recon + ".jxl", path("c.jpg")])
        _, n2, _, _ = tool_main(cjxl, [recon + ".jpg", path("c.jxl")])
        _, n3, _, _ = tool_main(djxl, [path("c.jxl"), path("c2.jpg")])
        with open(recon + ".jpg", "rb") as f:
            corpus_jpg = f.read()
        for name in ("c.jpg", "c2.jpg"):
            with open(path(name), "rb") as f:
                check(f.read() == corpus_jpg, f"jpeg_recon: {name} is not "
                      "the original JPEG")
        check(n == n2 == n3 == {}, f"JPEG host work launched {n} {n2} {n3}")
        _, n, _, err = tool_main(djxl, [recon + ".jxl", path("c.ppm"), "-v"])
        add(n)
        check(n == PATH_LAUNCHES["device:u8-ycbcr"]
              and "render path: device:u8-ycbcr" in err,
              f"djxl jpeg_recon.jxl to pixels: launches {n}; {err}")
        with open(recon + ".jxl", "rb") as f:
            corpus_ref = codestream.decode(extract_codestream(f.read()),
                                           device=None)[0]
        near_host(load_image(path("c.ppm")), corpus_ref,
                  "djxl jpeg_recon.jxl on the card")
        t = time.perf_counter()
        jrec, jpg, jdata, jref = jpeg_job.result()
        rec["jpeg_wait_s"] = time.perf_counter() - t
        with open(path("photo.jxl"), "wb") as f:
            f.write(jdata)
        secs, n, _, err = tool_main(djxl, [path("photo.jxl"),
                                           path("photo.ppm"), "-v"])
        add(n)
        check(n == PATH_LAUNCHES["device:u8-ycbcr"]
              and "render path: device:u8-ycbcr" in err,
              f"djxl of the recompressed JPEG: launches {n}; {err}")
        steps, share = near_host(load_image(path("photo.ppm")), jref,
                                 "djxl of the recompressed JPEG on the card")
        jrec.update(card_launches=n, card_djxl_s=secs, steps=steps,
                    share_off=share,
                    card_mp_s=mp_s(JPEG_SIDE * JPEG_SIDE, secs))
        rec["jpeg"] = jrec
        del jpg, jref
    rec["launches"] = total
    c = rec["cjxl"]
    log(f"phase tools: djxl {SIZE}^2 e5 on the card "
        + ", ".join(f"{v:.2f}" for v in rec["djxl_e5"]["card_mp_s"])
        + " MP/s beside --host "
        + ", ".join(f"{v:.2f}" for v in rec["djxl_e5"]["host_mp_s"])
        + f" MP/s (max {rec['djxl_e5']['max_steps']} step(s), "
        f"{rec['djxl_e5']['max_share_off']:.2e} off); --low_memory {BIG}^2 "
        f"{rec['djxl_low_memory']['mp_s']:.2f} MP/s, launches "
        f"{rec['djxl_low_memory']['launches']}; "
        + "; ".join(f"cjxl {r['image']} {r['mp_s']:.3f} MP/s (direct "
                    f"encode_lossy {r['direct_mp_s']:.3f}), launches "
                    f"{r['launches']}, bytes "
                    f"{'equal' if r['bytes_equal_direct'] else 'differ'}"
                    f" ({r['strategy_blocks_differ']} strategy blocks)"
                    for r in c)
        + f"; JPEG {JPEG_SIDE}^2: cjxl {rec['jpeg']['cjxl_s']:.2f} s, djxl "
        f"to .jpg {rec['jpeg']['djxl_jpg_s']:.2f} s (exact), djxl to pixels "
        f"on the card {rec['jpeg']['card_djxl_s']:.2f} s "
        f"({rec['jpeg']['card_mp_s']:.2f} MP/s, max "
        f"{rec['jpeg']['steps']} step(s)), waited "
        f"{rec['jpeg_wait_s']:.2f} s for the worker; Decoder e5 in "
        f"{DECODER_CHUNKS} chunks {rec['decoder_chunks']['mp_s']:.2f} MP/s "
        f"(no launch), blended animation launches "
        f"{rec['decoder_whole_stream']['launches']}; phase launches "
        f"{total}; {smi}")
    return total, rec


# The conformance runner, the fuzz harness and the last host tools on the
# card (drive_conformance_fuzz). The corpus holds two 2048^2 photos (d1/e5,
# and d2/e7, whose refinement launches render_tail once a round) and one
# lossless case at 256^2: the lossless encode is host Python. The metric
# CLIs run at METRIC_SIDE^2: their host metrics take ~70 s at 2048^2.
CONF_CASES = (("photo_e5", SIZE, 1100, ["-d", "1", "-e", "5"]),
              ("photo_e7", SIZE, 1101, ["-d", "2", "-e", "7"]),
              ("lossless", 256, 1102, ["--lossless"]))
CONF_LAUNCHES = {"photo_e5": RENDER_LAUNCHES,
                 "photo_e7": {"dequant_idct8": 1,
                              "render_tail": 1 + E7_ROUNDS},
                 "lossless": {}}
FUZZ_RUNS = (("decode", 200), ("container", 200), ("encode", 100))
FUZZ_SEED = 0
METRIC_SIDE, METRIC_SEED = 512, 1110
RD_SIDE, RD_SEED = 64, 1120


def _frame_errors(verbose_out):
    """(rmse, peak) of every frame line `conformance check -v` prints."""
    errs = []
    for line in verbose_out.splitlines():
        if line.strip().startswith("frame ") and "rmse=" in line:
            rmse = float(line.split("rmse=")[1].split()[0])
            peak = float(line.split("peak=")[1].split()[0])
            errs.append((rmse, peak))
    return errs


def drive_conformance_fuzz(e5, batch, dev, smi):
    """The conformance runner, the fuzz harness and the remaining tools on
    the card, each call through main(argv) (tool_main) or fuzz.run with the
    counters reset just before and read just after, in a temporary
    directory: `conformance generate --device cuda` of CONF_CASES (K1 and
    render_tail once a VarDCT case's reference decode, render_tail once
    more a refinement round at e7), `conformance check` of that corpus on
    the card (one K1 and one render_tail a VarDCT case) and with --host
    (no launch; the host decode held to the card-made references at the
    runner's own bounds); fuzz.run on the card for FUZZ_RUNS at seed
    FUZZ_SEED: no finding, and a nonzero count of inputs during which a
    kernel launched; then `batch` through check_kernels again, so that a
    sticky CUDA error left by a fuzzed launch fails here; then on the first
    2048^2 e5 stream: decode_and_encode to PPM and the decode_oneshot
    example (within 1 u8 step of the host decode), cjxl (the bytes of
    encode_lossy of load_image(device) with cjxl's arguments), cjpegli,
    the encode_oneshot example (its stream decoded on the card within 1
    step of the host decode); butteraugli_main and ssimulacra2_main of a
    METRIC_SIDE^2 .jxl against its PPM source; rd_measure of a RD_SIDE^2
    .jxl where the system libjxl is present (its own encode is host code).
    Returns (launches of the whole phase, record)."""
    import contextlib
    import io
    import tempfile

    from libjxl_tpu_torch.api import codestream, tpu_codec
    from libjxl_tpu_torch.base.device import reset_launch_counts
    from libjxl_tpu_torch.examples import decode_oneshot, encode_oneshot
    from libjxl_tpu_torch.extras import oracle
    from libjxl_tpu_torch.extras.io import load_image, save_image
    from libjxl_tpu_torch.io.container import extract_codestream
    from libjxl_tpu_torch.tools import (butteraugli_main, cjpegli, cjxl,
                                        conformance, decode_and_encode,
                                        fuzz, rd_measure, ssimulacra2_main)

    total = {}

    def add(n):
        for k, v in n.items():
            total[k] = total.get(k, 0) + v

    rec = {"steps": 0}
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        # the conformance corpus, generated on the card, checked both ways
        corpus = path("corpus")
        rec["generate"] = []
        for name, side, seed, extra in CONF_CASES:
            save_image(path(f"{name}.ppm"), make_image(side, side, seed))
            secs, n, out, _ = tool_main(conformance, [
                "generate", path(f"{name}.ppm"), "--out", corpus, *extra,
                "--device", "cuda"])
            add(n)
            check(n == CONF_LAUNCHES[name] and f"generated {name}" in out,
                  f"conformance generate {name}: launches {n}, not "
                  f"{CONF_LAUNCHES[name]}; {out}")
            rec["generate"].append({"case": name, "side": side,
                                    "args": extra, "s": secs,
                                    "launches": n})
        pixels = sum(side * side for _, side, _, _ in CONF_CASES)
        vardct = sum(1 for c in CONF_LAUNCHES.values() if c)
        for label, flag, want in (
                ("card", ["--device", "cuda"],
                 {k: vardct for k in RENDER_LAUNCHES}),
                ("host", ["--host"], {})):
            secs, n, out, _ = tool_main(conformance, ["check", corpus, "-v",
                                                      *flag])
            add(n)
            errs = _frame_errors(out)
            check(n == want and "3/3 cases pass" in out and len(errs) == 3,
                  f"conformance check ({label}): launches {n}, not {want}; "
                  f"{out}")
            rec[f"check_{label}"] = {
                "s": secs, "launches": n, "mp_s": mp_s(pixels, secs),
                "max_rmse": max(e[0] for e in errs),
                "max_peak": max(e[1] for e in errs)}

        # the fuzz harness on the card
        rec["fuzz"] = {}
        for target, iters in FUZZ_RUNS:
            stats, err = {}, io.StringIO()
            reset_launch_counts()
            t = time.perf_counter()
            with contextlib.redirect_stderr(err):
                findings = fuzz.run(target, iters, FUZZ_SEED, device=dev,
                                    stats=stats)
            secs = time.perf_counter() - t
            n = nonzero_counts()
            add(n)
            check(findings == 0 and stats["inputs"] == iters,
                  f"fuzz {target} on the card: {findings} finding(s): "
                  f"{err.getvalue()[-2000:]}")
            rec["fuzz"][target] = {**stats, "iters": iters,
                                   "findings": findings, "launches": n,
                                   "s": secs}
        reached = sum(r["reached_kernel"] for r in rec["fuzz"].values())
        check(reached > 0, "no fuzzed input reached a kernel launch")
        rec["fuzz_reached_kernel"] = reached
        config, args = tpu_codec.prepare_batch(batch)
        renderer, inputs = tpu_codec.batch_from_numpy(args, config, dev)
        after = check_kernels(renderer, inputs, config)
        rec["kernels_after_fuzz"] = {r["name"]: r["max_abs_err"]
                                     for r in after}
        del renderer, inputs, args

        # the tools and the examples on a 2048^2 .jxl input
        stream, ref = e5[0]
        src = path("e5.jxl")
        with open(src, "wb") as f:
            f.write(stream)
        mp_img = SIZE * SIZE
        rec["tools"] = {}

        def tool(name, mod, argv, pixels=mp_img):
            secs, n, out, _ = tool_main(mod, argv)
            add(n)
            check(n == RENDER_LAUNCHES,
                  f"{name}: launched {n}, not {RENDER_LAUNCHES}")
            rec["tools"][name] = {"s": secs, "launches": n,
                                  "mp_s": mp_s(pixels, secs)}
            return out

        def held(name, got, want):
            steps, share = near_host(got, want, f"{name} on the card")
            rec["tools"][name].update(steps=steps, share_off=share)
            rec["steps"] = max(rec["steps"], steps)

        tool("decode_and_encode", decode_and_encode, [src, path("dae.ppm")])
        held("decode_and_encode", load_image(path("dae.ppm")), ref)
        tool("decode_oneshot", decode_oneshot, [src, path("one.ppm")])
        held("decode_oneshot", load_image(path("one.ppm")), ref)
        tool("cjxl", cjxl, [src, path("re.jxl")])
        direct = codestream.encode_lossy(
            load_image(src, device=dev), distance=1.0, group_size_shift=1,
            icc=None, effort=3, progressive=1, resampling=1,
            photon_noise_iso=None, preview=None, intensity_target=None,
            iterations=None, already_downsampled=False, progressive_dc=False,
            group_order=0, center_x=None, center_y=None, epf=None,
            gaborish=None, dots=None, patches=None, noise=False, stats=None,
            debug_cb=None, device=dev)
        with open(path("re.jxl"), "rb") as f:
            check(f.read() == direct, "cjxl e5.jxl: bytes differ from "
                  "encode_lossy(load_image(e5.jxl, device)) with cjxl's "
                  "arguments")
        tool("cjpegli", cjpegli, [src, path("e5.jpg")])
        with open(path("e5.jpg"), "rb") as f:
            jpg = f.read()
        check(jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9",
              "cjpegli e5.jxl: not a JPEG")
        rec["tools"]["cjpegli"]["bytes"] = len(jpg)
        tool("encode_oneshot", encode_oneshot, [src, path("again.jxl")])
        with open(path("again.jxl"), "rb") as f:
            again = extract_codestream(f.read())
        held("encode_oneshot", codestream.decode(again, device=dev)[0],
             codestream.decode(again, device=None)[0])

        # the metric CLIs, and rd_measure where the system libjxl is
        img = make_image(METRIC_SIDE, METRIC_SIDE, METRIC_SEED)
        save_image(path("m.ppm"), img)
        with open(path("m.jxl"), "wb") as f:
            f.write(codestream.encode_lossy(img, distance=1.0, device=dev))
        for name, mod in (("butteraugli_main", butteraugli_main),
                          ("ssimulacra2_main", ssimulacra2_main)):
            rec["tools"][name]["score"] = float(tool(
                name, mod, [path("m.ppm"), path("m.jxl")], METRIC_SIDE ** 2))
        check(0 < rec["tools"]["butteraugli_main"]["score"] < 4
              and rec["tools"]["ssimulacra2_main"]["score"] > 50,
              f"metric CLIs at d1: {rec['tools']}")
        rec["oracle"] = oracle.available()
        if rec["oracle"]:
            small = make_image(RD_SIDE, RD_SIDE, RD_SEED)
            with open(path("rd.jxl"), "wb") as f:
                f.write(codestream.encode_lossy(small, effort=3, device=None))
            out = tool("rd_measure", rd_measure, [path("rd.jxl")],
                       RD_SIDE ** 2)
            check("over 12 cells" in out, f"rd_measure: {out[-500:]}")
    rec["launches"] = total
    t = rec["tools"]
    log(f"phase conformance+fuzz: generate "
        + ", ".join(f"{g['case']} {g['s']:.2f} s {g['launches']}"
                    for g in rec["generate"])
        + f"; check on the card {rec['check_card']['s']:.2f} s "
        f"({rec['check_card']['mp_s']:.2f} MP/s, rmse <= "
        f"{rec['check_card']['max_rmse']:.6f}), --host "
        f"{rec['check_host']['s']:.2f} s ({rec['check_host']['mp_s']:.2f} "
        f"MP/s, rmse <= {rec['check_host']['max_rmse']:.6f}, peak <= "
        f"{rec['check_host']['max_peak']:.6f}); fuzz "
        + ", ".join(f"{k} {v['iters']} inputs {v['findings']} findings "
                    f"{v['rejected']} rejected {v['reached_kernel']} reached "
                    f"a kernel {v['s']:.2f} s"
                    for k, v in rec["fuzz"].items())
        + "; " + ", ".join(f"{k} {v['s']:.2f} s" for k, v in t.items())
        + f"; max {rec['steps']} step(s); phase launches {total}; {smi}")
    return total, rec


# The block-layout decode (drive_block_layout): the entry point's step,
# the routes kernels.decode_pixels_hybrid and decode_render_blocks on a
# real stream's coefficients reshaped to blocks, and the block-layout
# sharded builder with per-tile CfL maps, each row shard WHOLE 64-px
# tiles (the JAX builder splits the maps over the row shards as it
# splits the block rows, so only then does sharded equal unsharded)
BLOCK_LAUNCHES = {"dequant_idct8": 1}
BLOCK_SHARD_LAUNCHES = {"dequant_idct8": SHARDS}
BLOCK_SEED = 1200


def hold_block_k1(route_out, blocks, args):
    """decode_pixels_hybrid's K1 on the card against the block-layout
    twin: the XYB that dequant_idct8 gives the route's contiguous
    image-layout copy against pipeline.decode_xyb of the blocks (K1_TOL),
    and the route's linear RGB equal to that XYB's colour transform.
    Returns the max abs error of the XYB."""
    import torch

    from libjxl_tpu_torch.ops import kernels, pipeline

    qf, dc, ytox, ytob, dm, igs, xdm, bdm = args
    qimg = pipeline.blocks_to_image(blocks).contiguous()
    xyb = kernels.dequant_idct8(qimg, qf, dc, ytox, ytob, dm,
                                torch.as_tensor(igs, device=qimg.device)
                                .reshape(-1).float(), xdm, bdm)
    ref = pipeline.decode_xyb(blocks, *args)
    torch.cuda.synchronize()
    err = max_err(xyb, ref)
    check(torch.allclose(xyb, ref, **K1_TOL), "a block-layout route's "
          f"dequant_idct8 disagrees with decode_xyb: max abs err {err}")
    check(torch.equal(route_out, pipeline.xyb_to_rgb(xyb)),
          "decode_pixels_hybrid is not its K1's XYB, colour-converted")
    return err


def drive_block_layout(stream, dev, smi):
    """The block-layout decode on the card, each route driven with the
    counters reset just before and read just after: entry.entry()'s step
    (one 256^2 group, 1 dequant_idct8) against its twin; the first 2048^2
    e3 stream's host-decoded coefficients reshaped to contiguous blocks,
    through decode_pixels_hybrid (1 dequant_idct8, its XYB within K1_TOL
    of pipeline.decode_xyb) and decode_render_blocks (1 dequant_idct8 + 1
    render_tail, equal to pipeline.decode_render_image of the same
    image-layout inputs, both kernels on the route's own inputs against
    their twins); each timed by CUDA events beside the image-layout call
    of the same data, the layout copy alone, and the twin on the card;
    build_sharded_decode on a (batch 2, rows 2) mesh of SHARDS entries at
    2 x 2048^2 (4 dequant_idct8) against the unsharded route plus a
    whole-image Gaborish, and the dry run's block-layout step
    (dryrun_codec_step) on the same mesh. Returns ({kernel: its
    "block_layout" record}, the phase's record)."""
    import torch

    from libjxl_tpu_torch import entry
    from libjxl_tpu_torch.base.device import reset_launch_counts
    from libjxl_tpu_torch.ops import kernels, pipeline
    from libjxl_tpu_torch.ops.staging import f32, to_device
    from libjxl_tpu_torch.parallel import dryrun

    rec = {}
    with torch.inference_mode():
        # entry(): the JAX package's flagship step on one 256^2 group
        fn, args = entry.entry("cuda")
        reset_launch_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        launches = nonzero_counts()
        check(launches == BLOCK_LAUNCHES, f"entry() launches {launches}")
        step = (1024.0, 1.0, 1.0)
        err = hold_block_k1(out, args[0], (*args[1:], *step))
        rec["entry"] = {"launches": launches, "shape": list(out.shape),
                        "max_abs_err": err,
                        "ms": cuda_ms(lambda: fn(*args), 10),
                        "plain_ms": cuda_ms(lambda: pipeline.decode_pixels(
                            *args, *step), 3)}

        # a real stream's coefficients in the block layout
        sr = dryrun.StreamRender.of(stream).on(dev)
        lf, igs, xdm, bdm, gab, chs = sr.params
        qimg, qf, dc, ytox, ytob, dm, ispx, sad = sr.args
        blocks = pipeline.image_to_blocks(qimg).contiguous()
        k1_args = (qf, dc, ytox, ytob, dm, igs, xdm, bdm)
        h, w = qimg.shape[-2:]
        npx = h * w

        reset_launch_counts()
        out = kernels.decode_pixels_hybrid(blocks, *k1_args)
        torch.cuda.synchronize()
        launches = nonzero_counts()
        check(launches == BLOCK_LAUNCHES,
              f"decode_pixels_hybrid launches {launches}")
        err = hold_block_k1(out, blocks, k1_args)
        igs_t = torch.full((1,), igs, device=dev)

        def image_layout():
            return pipeline.xyb_to_rgb(kernels.dequant_idct8(
                qimg, qf, dc, ytox, ytob, dm, igs_t, xdm, bdm))

        check(torch.equal(out, image_layout()), "decode_pixels_hybrid "
              "differs from the image-layout K1 + colour transform")
        k1_bound = bound(tensor_bytes(qimg, qf, dc, ytox, ytob, dm, igs_t)
                         + 4 * qimg.numel(), K1_OPS * qimg.numel())
        hybrid = {
            "launches": launches, "max_abs_err": err,
            "ms": cuda_ms(lambda: kernels.decode_pixels_hybrid(
                blocks, *k1_args), 10),
            "image_layout_ms": cuda_ms(image_layout, 10),
            "k1_ms": cuda_ms(lambda: kernels.dequant_idct8(
                qimg, qf, dc, ytox, ytob, dm, igs_t, xdm, bdm), 10),
            "copy_ms": cuda_ms(lambda: pipeline.blocks_to_image(
                blocks).contiguous(), 10),
            "copy_bytes": 2 * tensor_bytes(blocks),
            "plain_ms": cuda_ms(lambda: pipeline.decode_pixels(
                blocks, *k1_args), 3),
            **k1_bound}
        del out

        gab = to_device(gab, dev)
        tail = (gab, ispx, sad, chs, int(lf.epf_iters))
        scales = (f32(lf.epf_pass0_sigma_scale),
                  f32(lf.epf_pass2_sigma_scale))
        with KernelSpy(keep=0) as spy:
            reset_launch_counts()
            out = kernels.decode_render_blocks(blocks, *k1_args, *tail,
                                               True, *scales)
            torch.cuda.synchronize()
            launches = nonzero_counts()
        check(launches == RENDER_LAUNCHES,
              f"decode_render_blocks launches {launches}")
        sigma = sr.sigma

        def image_render():
            return pipeline.decode_render_image(
                qimg, qf, dc, ytox, ytob, dm, igs, xdm, bdm, gab, sigma,
                sad, chs, int(lf.epf_iters), True, *scales)

        equal = bool(torch.equal(out, image_render()))
        check(equal, "decode_render_blocks differs from the image-layout "
              "render of the same inputs")
        spied = check_shard_kernels(spy)
        del spy, out
        render = {
            "launches": launches, "equal_to_image_layout": equal,
            "epf_iters": int(lf.epf_iters), "gaborish": bool(lf.gab),
            "ms": cuda_ms(lambda: kernels.decode_render_blocks(
                blocks, *k1_args, *tail, True, *scales), 10),
            "image_layout_ms": cuda_ms(image_render, 10),
            "plain_ms": cuda_ms(lambda: pipeline.decode_render(
                blocks, *k1_args, *tail, True, *scales), 3),
            "kernels": spied}
        del sr, blocks, qimg
    rec["stream"] = f"{h}x{w} d1/e3 (the first batch stream)"
    rec["hybrid"], rec["render"] = hybrid, render

    rec["sharded"] = drive_block_sharded(dev)
    log(f"phase block layout: entry() {rec['entry']['ms']:.4f} ms (plain "
        f"{rec['entry']['plain_ms']:.4f}); on {rec['stream']}: "
        f"decode_pixels_hybrid {hybrid['ms']:.4f} ms (its layout copy "
        f"{hybrid['copy_ms']:.4f} ms, K1 {hybrid['k1_ms']:.4f} ms; the "
        f"image-layout call {hybrid['image_layout_ms']:.4f} ms; plain "
        f"{hybrid['plain_ms']:.4f} ms; K1 bound {hybrid['bound_ms']:.4f} "
        f"ms), decode_render_blocks {render['ms']:.4f} ms (image layout "
        f"{render['image_layout_ms']:.4f} ms, equal; plain "
        f"{render['plain_ms']:.4f} ms); sharded {rec['sharded']['ms']:.4f}"
        f" ms vs unsharded {rec['sharded']['unsharded_ms']:.4f} ms "
        f"(equal); "
        f"CUDA events; {smi}")
    k1 = {"launches": sum(r["launches"].get("dequant_idct8", 0)
                          for r in (rec["entry"], hybrid, render,
                                    rec["sharded"],
                                    rec["sharded"]["dryrun_step"])),
          "ms": hybrid["k1_ms"], "route_ms": hybrid["ms"],
          "copy_ms": hybrid["copy_ms"],
          "image_layout_ms": hybrid["image_layout_ms"],
          "plain_ms": hybrid["plain_ms"],
          "max_abs_err": max(rec["entry"]["max_abs_err"],
                             hybrid["max_abs_err"],
                             spied["dequant_idct8"]["max_abs_err"]),
          **{k: hybrid[k] for k in ("bound_ms", "bound_by", "library_ms")}}
    k2 = {"launches": render["launches"]["render_tail"],
          "ms": spied["render_tail"]["ms_per_shard"],
          "route_ms": render["ms"],
          "image_layout_ms": render["image_layout_ms"],
          **{k: spied["render_tail"][k] for k in (
              "plain_ms", "max_abs_err", "bound_ms", "bound_by",
              "library_ms")}}
    return {"dequant_idct8": k1, "render_tail": k2}, rec


# The programs phase (drive_programs): each of the port's programs
# (ops/programs.py, the JAX package's jitted programs) on an input an
# earlier phase hands it, by label: (program name, the call to keep, which
# of the program's calls on the card it is: wants(key, args, kwargs)).
# The tile-cost labels are those of the LADDER sizes that the SIZE^2
# encodes reached (the 128 and 256 rungs run only where some 128^2 area
# is smooth)
def _first(key, args, kw):
    return True


def _entry(phase, entry, width=None):
    """A sharded builder's call of `phase` on mesh entry `entry` (keys end
    in (phase, (b, r))), whose first input is width() wide."""
    def wants(key, args, kw):
        return tuple(key[-2:]) == (phase, entry) and (
            width is None or args[0].shape[-1] == width())
    return wants


PROGRAM_CALLS = {
    "batch": ("batch", "the first 16-stream batch", _first),
    "dec_image": ("dec_image", "the 2048^2 e5 frame",
                  lambda key, args, kw: tuple(kw["qimg"].shape)
                  == (3, SIZE, SIZE)),
    "dec_sub": ("dec_sub", "the 2048^2 4:2:0 YCbCr frame", _first),
    "strip": ("dec_image", "a 4096^2 e3 strip (a middle one, haloed)",
              lambda key, args, kw: tuple(kw["qimg"].shape)
              == (3, 384, BIG)),
    "enc": ("enc", "a 2048^2 d1/e3 encode",
            lambda key, args, kw: args[0].shape[-1] == SIZE),
    "chunk_prep": ("chunk_prep", "the first streaming DC group's prep",
                   _first),
    "chunk_step": ("chunk_step", "the first streaming DC group's step",
                   _first),
    "dec": ("dec", "entry()'s 256^2 group (decode_pixels_hybrid)",
            lambda key, args, kw: tuple(args[0].shape) == (3, 32, 32, 8, 8)),
    "dec_full": ("dec_full", "the block route on a 2048^2 e3 stream "
                             "(decode_render_blocks)", _first),
    "entropy": ("entropy", "the first 16-stream batch, device entropy",
                _first),
    "trial": ("trial", "the 2048^2 e7 encode's first refinement round",
              lambda key, args, kw: tuple(args[2].shape)
              == (SIZE // 8, SIZE // 8)),
    "diffmap": ("diffmap", "the 2048^2 e7 encode's first refinement round",
                lambda key, args, kw: tuple(args[0].shape)
                == (3, SIZE, SIZE)),
    "sharded_stream.1": ("sharded_stream", f"the {SHARD_BIG}^2 band "
                         "program's second band: K1",
                         _entry(1, (0, 1), lambda: SHARD_BIG)),
    "sharded_stream.2": ("sharded_stream", f"the {SHARD_BIG}^2 band "
                         "program's second band: the composite, K2",
                         _entry(2, (0, 1), lambda: SHARD_BIG)),
    "sharded_full.1": ("sharded_full", "2 x 2048^2 on the (2, 2) mesh, "
                       "entry (1, 1): K1", _entry(1, (1, 1))),
    "sharded_full.2": ("sharded_full", "2 x 2048^2 on the (2, 2) mesh, "
                       "entry (1, 1): the composite, K2, RGB",
                       _entry(2, (1, 1))),
    "sharded_encode": ("sharded_encode", "2 x 2048^2 on the (2, 2) mesh, "
                       "entry (1, 1)", _entry(1, (1, 1), lambda: SIZE)),
    "sharded_decode.1": ("sharded_decode", "2 x 2048^2 blocks on the (2, 2) "
                         "mesh, entry (1, 1): the hybrid decode",
                         lambda key, args, kw: tuple(key[-2:]) == (1, (1, 1))
                         and args[0].shape[3] == SIZE // 8),
    "sharded_decode.2": ("sharded_decode", "2 x 2048^2 blocks on the (2, 2) "
                         "mesh, entry (1, 1): Gaborish",
                         _entry(2, (1, 1), lambda: SIZE)),
    "sharded_chunk": ("sharded_chunk", f"the {BIG}^2 streaming encode's "
                      "first DC group, entry 1", _entry(1, (0, 1))),
    **{f"tile_cost {r}x{c}": (
        "tile_cost", f"a {SIZE}^2 search's {r}x{c} tiles",
        lambda key, args, kw, r=r, c=c: tuple(key[:2]) == (r, c)
        and tuple(args[0].shape) == (3, SIZE, SIZE))
       for r, c, _ in LADDER},
}
PROGRAM_REPS = 5


class ProgramSpy:
    """While installed, keeps for each label of PROGRAM_CALLS the first
    programs.run call of its program on the card (the CPU references run
    the bodies directly) that the label wants: (name, key, fn, args,
    kwargs) with the inputs as the call site gave them, a tensor on the
    card cloned (a builder hands a phase's own outputs to the next phase,
    which a later call overwrites), so that drive_programs can run the
    program on them again."""

    def __init__(self):
        self.calls, self.orig = {}, None

    def __enter__(self):
        import torch

        from libjxl_tpu_torch.ops import programs

        self.orig = run = programs.run

        def keep(tree):
            inputs, spec = programs.flatten(tree)
            return programs.unflatten(spec, [
                x.clone() if isinstance(x, torch.Tensor) and x.is_cuda
                else x for x in inputs])

        def spy(name, key, fn, *args, **kw):
            on_card = torch.device(kw["device"]).type == "cuda"
            for label, (prog, _, wants) in PROGRAM_CALLS.items():
                if on_card and prog == name and label not in self.calls \
                        and wants(key, args, kw):
                    self.calls[label] = (name, key, fn, *keep((args, kw)))
                    break
            return run(name, key, fn, *args, **kw)

        programs.run = spy
        return self

    def __exit__(self, *exc):
        from libjxl_tpu_torch.ops import programs

        programs.run = self.orig


def _same(a, b):
    """Bitwise equality of two program results."""
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and bool(torch.equal(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def drive_programs(calls, dev, smi):
    """Each program of the port on the inputs an earlier phase gave it
    (ProgramSpy, PROGRAM_CALLS), eager against replay: the eager call
    (cache cleared before it) and the replay give equal results, bitwise,
    with equal launches; each call timed by the host clock (synchronized)
    and by CUDA events, mean of PROGRAM_REPS; the body alone (eager on
    inputs already on the card, and the graph's replay alone) by CUDA
    events and the host clock; the rest of a call by the host clock (the
    upload of its inputs, their copy into the slots, the readback or
    clone of its outputs), and its largest host input copied from
    pageable and from pinned memory; the capture's host seconds; the
    device memory the cached program holds (slots, pool, after
    empty_cache; and as the cache counts it, Program.held) and an eager
    call's peak above what was allocated before it. Returns the phase's
    record."""
    import gc

    import torch

    from libjxl_tpu_torch.ops import programs

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        out, n = counted(fn)
        end.record()
        torch.cuda.synchronize()
        return out, n, (time.perf_counter() - t) * 1e3, \
            start.elapsed_time(end)

    def mean_of(fn, reps=PROGRAM_REPS, before=None):
        host, ev = [], []
        for _ in range(reps):
            if before:
                before()
            out, n, h, e = timed(fn)
            host.append(h)
            ev.append(e)
        return out, n, float(np.mean(host)), float(np.mean(ev))

    wanted = {label for label in PROGRAM_CALLS
              if not label.startswith("tile_cost")}
    tiles = sorted(label for label in calls if label.startswith("tile_cost"))
    check(wanted <= set(calls) and tiles,
          f"programs phase: the earlier phases gave {sorted(calls)}, not "
          f"every one of {sorted(wanted)} and a tile size")
    log(f"programs phase: the {SIZE}^2 encodes ran {len(tiles)} tile sizes: "
        + ", ".join(t.split()[1] for t in tiles))
    rec = {}
    for label, (name, key, fn, args, kw) in calls.items():
        def call():
            return programs.run(name, key, fn, *args, **kw)

        def clear():
            programs.clear(dev)

        eager, n_eager, eager_host, eager_ev = mean_of(call, before=clear)
        # the eager call's peak above what it finds allocated
        clear()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        timed(call)
        eager_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        captured, n_capture, capture_host, _ = timed(call)
        (prog,) = [p for p in programs.programs(dev) if p.name == name]
        check(prog.mode == "replay", f"program {label}: {prog.mode} after "
              "its second call")
        replayed, n_replay, replay_host, replay_ev = mean_of(call)
        prog_held = prog.held / 1e9
        gc.collect()
        torch.cuda.empty_cache()
        held = (torch.cuda.memory_reserved() - reserved) / 1e9
        # the body alone: eager on inputs on the card, the graph alone
        inputs, spec = programs.flatten((args, kw))
        on = programs.unflatten(spec, [programs._on(x, dev)
                                       for x in inputs])
        def body():
            return fn(*on[0], **{k: v for k, v in on[1].items()
                                 if k not in ("device", "readback",
                                              "clone")})

        # each after one untimed run, so that no cudaMalloc of the
        # allocator emptied above is timed
        with torch.inference_mode():
            body()
            _, _, body_host, body_ev = mean_of(body)
        prog.graph.replay()
        _, _, graph_host, graph_ev = mean_of(prog.graph.replay)
        del on
        # the rest of a call: its host inputs' upload (eager) or their
        # copy into the slots (replay), and its outputs' readback (or
        # clone); the largest host input also from pinned memory
        outs = programs.flatten(prog.out)[0]
        readback = kw.get("readback", False)
        _, _, upload_ms, _ = mean_of(
            lambda: [programs._on(x, dev) for x in inputs])
        _, _, load_ms, _ = mean_of(lambda: prog._load(inputs))
        back_ms = 0.0  # a builder's phase hands its own outputs on
        if readback or kw.get("clone", True):
            _, _, back_ms, _ = mean_of(
                lambda: [t.cpu().numpy() if readback else t.clone()
                         for t in outs])
        host_in = [x for x in inputs if isinstance(x, np.ndarray)]
        pinned_ms = pageable_ms = None
        if host_in:
            big = programs._host(max(host_in, key=lambda x: x.nbytes))
            pinned = big.pin_memory()
            slot = torch.empty(big.shape, dtype=big.dtype, device=dev)
            _, _, pageable_ms, _ = mean_of(lambda: slot.copy_(big))
            _, _, pinned_ms, _ = mean_of(
                lambda: slot.copy_(pinned, non_blocking=True))
            del pinned, slot
        del outs
        check(_same(eager, captured) and _same(eager, replayed),
              f"program {label}: the replay differs from the eager call")
        check(n_eager == n_capture == n_replay,
              f"program {label}: launches eager {n_eager}, capture "
              f"{n_capture}, replay {n_replay}")
        rec[label] = {
            "program": name, "input": PROGRAM_CALLS[label][1],
            "key": repr(key), "launches": n_replay, "bitwise_equal": True,
            "eager_call_ms": eager_host, "eager_call_event_ms": eager_ev,
            "replay_call_ms": replay_host, "replay_call_event_ms": replay_ev,
            "eager_body_ms": body_host, "eager_body_event_ms": body_ev,
            "replay_graph_ms": graph_host, "replay_graph_event_ms": graph_ev,
            "capture_ms": prog.capture_s * 1e3,
            "capture_call_ms": capture_host,
            "eager_upload_ms": upload_ms, "replay_load_ms": load_ms,
            "readback_ms": back_ms,
            "largest_input_mb": (max(x.nbytes for x in host_in) / 1e6
                                 if host_in else 0.0),
            "largest_input_pageable_ms": pageable_ms,
            "largest_input_pinned_ms": pinned_ms,
            "eager_peak_gb": eager_peak, "held_gb": held,
            "cache_held_gb": prog_held}
        log(f"program {label} ({name}, {PROGRAM_CALLS[label][1]}): "
            f"launches {json.dumps(n_replay)}; call eager "
            f"{eager_host:.4f} ms, replay {replay_host:.4f} ms (host "
            f"clock; events {eager_ev:.4f} / {replay_ev:.4f}); body eager "
            f"{body_ev:.4f} ms, graph replay {graph_ev:.4f} ms (events; "
            f"host {body_host:.4f} / {graph_host:.4f}); capture "
            f"{prog.capture_s * 1e3:.2f} ms; upload {upload_ms:.4f} / slot "
            f"load {load_ms:.4f} ms, readback {back_ms:.4f} ms (host "
            f"clock); largest host input pageable {pageable_ms} / pinned "
            f"{pinned_ms} ms; held {held:.3f} GB (the cache counts "
            f"{prog_held:.3f}), eager peak "
            f"{eager_peak:.3f} GB; bitwise equal; {smi}")
        # nothing of this program outlives it: the next one's baseline
        del eager, captured, replayed, prog
        programs.clear(dev)
    return rec


def drive_block_sharded(dev):
    """build_sharded_decode on a (batch 2, rows 2) mesh of SHARDS entries
    (the cards in turn) at 2 x SIZE^2 with nonzero per-tile CfL maps,
    counted, against the unsharded route on the card
    (decode_pixels_hybrid of the batch, then a whole-image Gaborish):
    equal (whole tiles a shard, the same kernel and the same blur on both
    sides); then dryrun_codec_step on the same mesh
    (its 4 shard launches and the unsharded reference's one)."""
    import torch

    from libjxl_tpu_torch.base.device import reset_launch_counts
    from libjxl_tpu_torch.ops import kernels, pipeline
    from libjxl_tpu_torch.ops.staging import to_device
    from libjxl_tpu_torch.parallel import dryrun, sharding
    from libjxl_tpu_torch.vardct.quant_weights import library_tables

    mesh = sharding.make_mesh(dryrun.mesh_devices(SHARDS, "cuda"), batch=2)
    rng = np.random.default_rng(BLOCK_SEED)
    b, nby = 2, SIZE // 8
    nty = nby // 8
    dm = library_tables()[0][0]
    shape = (b, 3, nby, nby, 8, 8)
    args = to_device((
        (rng.integers(-3, 4, shape, dtype=np.int32)
         * (rng.random(shape, dtype=np.float32) < 0.1)).astype(np.int32),
        rng.integers(32, 128, (b, nby, nby)).astype(np.int32),
        rng.normal(0, 0.2, (b, 3, nby, nby)).astype(np.float32),
        rng.integers(-10, 10, (b, nty, nty)).astype(np.int32),
        rng.integers(-45, -30, (b, nty, nty)).astype(np.int32), dm), dev)
    run = sharding.build_sharded_decode(mesh)
    reset_launch_counts()
    got = run(*args)
    torch.cuda.synchronize()
    launches = nonzero_counts()
    check(launches == BLOCK_SHARD_LAUNCHES,
          f"build_sharded_decode launches {launches}")
    replays_equal(run, args, got, BLOCK_SHARD_LAUNCHES,
                  "build_sharded_decode", list(mesh.devices.flat),
                  named("sharded_decode"))

    def unsharded():
        with torch.inference_mode():
            rgb = kernels.decode_pixels_hybrid(*args, 1024.0)
            return pipeline.gaborish(rgb, sharding.GAB_KERNELS)

    ref = unsharded()
    torch.cuda.synchronize()
    err = max_err(got, ref)
    check(torch.equal(got, ref), "build_sharded_decode differs from the "
          f"unsharded route: max abs err {err}")
    rec = {"mesh": repr(mesh), "image": f"2 x {SIZE}^2",
           "launches": launches, "max_abs_err": err,
           "ms": cuda_ms(lambda: run(*args), 3),
           "unsharded_ms": cuda_ms(unsharded, 3)}
    del got, ref, args
    reset_launch_counts()
    step = dryrun.dryrun_codec_step(mesh, np.random.default_rng(1))
    torch.cuda.synchronize()
    launches = nonzero_counts()
    check(launches == {"dequant_idct8": SHARDS + 1},
          f"the dry run's block-layout step launches {launches}")
    rec["dryrun_step"] = {**step, "launches": launches}
    return rec


def main_sharded(dev, smi, kind):
    """python3 chip_smoke.py --sharded: the multi-device phase alone
    (drive_sharded, then drive_block_sharded) on a mesh of SHARDS entries
    of the cards in turn, so four real cards on a machine that has them,
    with the inputs it needs: the first 16 2048^2 d1/e3 streams, their
    batched decode and the BIG^2 photo's hosts=1 streaming bytes. Prints
    the phase's record, the card line and the ok line."""
    import concurrent.futures as cf
    import multiprocessing as mp

    import torch

    from libjxl_tpu_torch.api import codestream, tpu_codec

    t = time.perf_counter()
    jobs = [(SIZE, SIZE, 100 + i, None) for i in range(BATCH)]
    with cf.ProcessPoolExecutor(min(len(jobs), os.cpu_count() or 1),
                                mp_context=mp.get_context("spawn")) as ex:
        done = list(ex.map(encode_and_reference, jobs))
    main16 = [stream for stream, _ in done]
    piped16 = tpu_codec.decode_pipelined(main16, dev, batch_size=BATCH)
    big = make_image(BIG, BIG, 600)
    big_bytes = codestream.encode_lossy_streaming(big, distance=1.0,
                                                  device=dev)
    log(f"phase sharded inputs: {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    _, rec = drive_sharded(main16, piped16, big, big_bytes, dev, smi)
    rec["block_sharded"] = drive_block_sharded(dev)
    log(f"phase sharded: {time.perf_counter() - t:.2f} s")
    print(json.dumps({"sharded": rec}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None):
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a GPU",
              file=sys.stderr)
        return 1
    from libjxl_tpu_torch import native_ext
    from libjxl_tpu_torch.api import tpu_codec
    from libjxl_tpu_torch.base.device import (card_line,
                                              reset_launch_counts,
                                              resolve_device)
    from libjxl_tpu_torch.ops import build, programs

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = card_line()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    check(native_ext.get_lib() is not None,
          "the port's native host library did not build: host entropy "
          "would run in pure Python")

    t = time.perf_counter()
    so = build.build()
    build.load()
    log(f"phase build: {time.perf_counter() - t:.2f} s ({so.name})")
    for line in so.with_suffix(".log").read_text().splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    if argv == ["--sharded"]:
        return main_sharded(dev, smi, kind)
    check(not argv, f"arguments {argv}: none, or --sharded")

    import concurrent.futures as cf
    import multiprocessing as mp

    # every phase below runs through the port's programs; the spy keeps
    # the calls drive_programs runs again
    spy = ProgramSpy()
    spy.__enter__()

    # the single-image path's streams first: the e5 encodes take longest
    single_jobs = ([(SIZE, SIZE, 400 + i, "e5") for i in range(E5_FRAMES)]
                   + [(*ODD_SIZE, 410 + i, "e5") for i in range(2)]
                   + [(MIXED_E5, MIXED_E5, 420, "e5"),
                      (SIZE, SIZE, 430, "ycbcr")])
    jobs = single_jobs + (
        [(SIZE, SIZE, 100 + i, None) for i in range(2 * BATCH)]
        + [(SIZE, SIZE, 200 + i, 3) for i in range(4)]
        + [(*ODD_SIZE, 300 + i, None) for i in range(2)]
        + [(512, 512, seed, "small") for seed in (7, 8)])
    t = time.perf_counter()
    workers = min(len(jobs), os.cpu_count() or 1)
    # a worker that dies raises BrokenProcessPool here instead of hanging
    with cf.ProcessPoolExecutor(workers,
                                mp_context=mp.get_context("spawn")) as ex:
        done = list(ex.map(encode_and_reference, jobs))
    log(f"phase encode+host-decode: {time.perf_counter() - t:.2f} s "
        f"({len(jobs)} streams, {workers} processes)")
    check(len({s for s, _ in done}) == len(done), "streams are not distinct")
    single, done = done[:len(single_jobs)], done[len(single_jobs):]
    e5_s = single[:E5_FRAMES]
    odd5_s = single[E5_FRAMES:E5_FRAMES + 2]
    mixed_e5, ycc = single[-2:]
    streams = [s for s, _ in done]
    refs = [r for _, r in done]
    main_s, main_r = streams[:2 * BATCH], refs[:2 * BATCH]
    epf3_s, epf3_r = streams[2 * BATCH:2 * BATCH + 4], \
        refs[2 * BATCH:2 * BATCH + 4]
    odd_s, odd_r = streams[-4:-2], refs[-4:-2]
    small_s = streams[-2:]
    mp_per_image = SIZE * SIZE / 1e6

    # host entropy (+ staging) of one batch, then the kernels against
    # their plain twins on that batch's real inputs
    t = time.perf_counter()
    config, args = tpu_codec.prepare_batch(main_s[:BATCH])
    t_host = time.perf_counter() - t
    check(config.epf_iters == 2 and config.gab,
          f"default encode should signal Gaborish + 2 EPF passes: {config}")
    renderer, inputs = tpu_codec.batch_from_numpy(args, config, dev)
    records = check_kernels(renderer, inputs, config)
    split = render_split(renderer, inputs)
    records.append(check_ans_decode(small_s, main_s[:BATCH], args[0], dev,
                                    smi))

    def render_once():
        return renderer(*inputs)

    with torch.inference_mode():
        render_ms = cuda_ms(render_once, 5)
        torch.cuda.reset_peak_memory_stats()
        render_once()
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del renderer, inputs, args

    # the main path, counted
    reset_launch_counts()
    t = time.perf_counter()
    piped = tpu_codec.decode_pipelined(main_s, dev, batch_size=BATCH)
    t_pipe = time.perf_counter() - t
    launches = nonzero_counts()
    batches = len(main_s) // BATCH
    check(launches == {"dequant_idct8": batches, "render_tail": batches},
          f"main path launches {launches}")
    for rec in records[:2]:
        rec["launches"] = launches[rec["name"]]
    check_images(piped, main_r, "decode_pipelined 2048x2048 d1/e3")

    for start in range(0, len(main_s), BATCH):
        outs, n = counted(tpu_codec.decode_batch, main_s[start:start + BATCH],
                          dev)
        check(n == RENDER_LAUNCHES, f"decode_batch launches {n}")
        for a, b in zip(outs, piped[start:start + BATCH]):
            check(np.array_equal(a, b), "pipelined output differs from "
                  "the batched output")
    log("decode_batch per batch of 16 == decode_pipelined, exactly")

    outs, n = counted(tpu_codec.decode_batch, epf3_s, dev)
    check(n == RENDER_LAUNCHES, f"epf=3 decode_batch launches {n}")
    check_images(outs, epf3_r, "decode_batch 2048x2048 epf=3")
    odd_outs, n = counted(tpu_codec.decode_batch, odd_s, dev)
    check(n == RENDER_LAUNCHES, f"1021x765 decode_batch launches {n}")
    check_images(odd_outs, odd_r, "decode_batch 1021x765 (true-size mirror)")
    odd_config, odd_args = tpu_codec.prepare_batch(odd_s)
    check(odd_config.true_size == ODD_SIZE,
          f"1021x765 true size {odd_config.true_size}")
    odd_split = render_split(*tpu_codec.batch_from_numpy(odd_args,
                                                         odd_config, dev))
    del odd_args

    # the device-entropy path, counted
    reset_launch_counts()
    t = time.perf_counter()
    ent = [counted(tpu_codec.decode_batch_entropy,
                   main_s[start:start + BATCH], dev)
           for start in range(0, len(main_s), BATCH)]
    t_ent = time.perf_counter() - t
    launches = nonzero_counts()
    check(launches == {"dequant_idct8": batches, "ans_decode": batches,
                       "render_tail": batches},
          f"device-entropy path launches {launches}")
    records[2]["launches"] = launches["ans_decode"]
    for i, ((outs, info), n) in enumerate(ent):
        check(info == {"path": "device_entropy"},
              f"decode_batch_entropy batch {i}: {info}")
        check(n == {"ans_decode": 1, **RENDER_LAUNCHES},
              f"decode_batch_entropy batch {i} launches {n}")
        for a, b in zip(outs, piped[i * BATCH:(i + 1) * BATCH]):
            check(np.array_equal(a, b), "device-entropy output differs "
                  "from decode_pipelined's")
        check_images(outs, main_r[i * BATCH:(i + 1) * BATCH],
                     f"decode_batch_entropy batch {i}")
    log("decode_batch_entropy per batch of 16 == decode_pipelined, exactly")
    # the batches hold other images of one geometry: they share one
    # "entropy" program, which the first ran eagerly and the next
    # captured and replayed
    ent_progs = [p for p in programs.programs(dev) if p.name == "entropy"]
    check(len(ent_progs) == 1 and ent_progs[0].mode == "replay"
          and ent_progs[0].calls == batches,
          "the device-entropy batches did not share one program: "
          + repr([(p.key, p.calls, p.mode) for p in ent_progs]))
    log(f"decode_batch_entropy: {batches} batches of other images, one "
        f"program, captured at the second batch ({ent_progs[0].key})")
    # the stage split of the same path, in a run of its own: its stage
    # timer synchronizes the device at every stage's end
    stages = {}
    (outs, info), n = counted(tpu_codec.decode_batch_entropy,
                              main_s[BATCH:], dev, stages=stages)
    check(info == {"path": "device_entropy"}
          and n == {"ans_decode": 1, **RENDER_LAUNCHES},
          f"stage-timed decode_batch_entropy: {info}, launches {n}")
    for a, b in zip(outs, piped[BATCH:]):
        check(np.array_equal(a, b), "stage-timed device-entropy output "
              "differs from decode_pipelined's")

    # the single-image path (codestream.decode with a device), counted,
    # then the public batch entry on a mixed list, counted
    t = time.perf_counter()
    single_launches, single_recs = drive_single(e5_s, odd5_s, ycc, dev, smi)
    for rec in records[:2]:
        rec["single_image"] = {**single_recs[rec["name"]],
                               "launches": single_launches[rec["name"]]}
    drive_mixed_batch(list(zip(main_s[:BATCH], main_r[:BATCH])),
                      list(zip(odd_s, odd_r)), [mixed_e5], piped[:BATCH],
                      odd_outs, dev)
    log(f"phase single-image + mixed decode_batch: "
        f"{time.perf_counter() - t:.2f} s")

    # the device encode, the streaming encode and the bounded-memory
    # strips, each counted
    t = time.perf_counter()
    paths = {"encode": drive_encode(dev, smi)}
    big = make_image(BIG, BIG, 600)
    big_bytes, paths["streaming"] = drive_streaming(big, dev, smi)
    strip_launches, paths["strips"] = drive_strips(big, e5_s[0][0],
                                                   odd_s[0], dev, smi)
    for rec in records[:2]:
        name = rec["name"]
        rec["strips"] = {
            "launches": strip_launches[name],
            "strips": paths["strips"]["strips"],
            "ms_per_strip": paths["strips"]["split_ms_per_strip"][name],
            "max_abs_err": paths["strips"]["twins"][name]["max_abs_err"]}
    log(f"phase encode + streaming + strips: "
        f"{time.perf_counter() - t:.2f} s")

    # the encoder heuristics on the card (e5 tile costs, e7 refinement)
    t = time.perf_counter()
    records[1]["refine_trial"], paths["heuristics"] = drive_heuristics(
        dev, smi)
    log(f"phase encoder heuristics: {time.perf_counter() - t:.2f} s")

    # the multi-device path on a mesh (virtual on one card), counted
    t = time.perf_counter()
    sharded, paths["sharded"] = drive_sharded(main_s[:BATCH], piped[:BATCH],
                                              big, big_bytes, dev, smi)
    for rec in records[:2]:
        rec["sharded"] = sharded[rec["name"]]
    log(f"phase sharded: {time.perf_counter() - t:.2f} s")

    # the user entry points: the CLIs, the Decoder and the Encoder
    t = time.perf_counter()
    tools, paths["tools"] = drive_tools(e5_s, big, dev, smi)
    del big
    for rec in records[:2]:
        rec["tools"] = {"launches": tools.get(rec["name"], 0)}
    log(f"phase tools: {time.perf_counter() - t:.2f} s")

    # the conformance runner, the fuzz harness and the last tools, counted
    t = time.perf_counter()
    conf, paths["conformance_fuzz"] = drive_conformance_fuzz(
        e5_s, main_s[:BATCH], dev, smi)
    for rec in records[:2]:
        rec["conformance_fuzz"] = {"launches": conf.get(rec["name"], 0)}
    paths["conformance_fuzz"]["phase_s"] = time.perf_counter() - t
    log(f"phase conformance+fuzz: {time.perf_counter() - t:.2f} s")

    # the block-layout decode: entry(), its two routes and the
    # block-layout sharded builder, counted
    t = time.perf_counter()
    block, paths["block_layout"] = drive_block_layout(main_s[0], dev, smi)
    for rec in records[:2]:
        rec["block_layout"] = block[rec["name"]]
    log(f"phase block layout: {time.perf_counter() - t:.2f} s")

    # the programs: each eager against its replay on an earlier phase's
    # inputs
    spy.__exit__()
    t = time.perf_counter()
    paths["programs"] = drive_programs(spy.calls, dev, smi)
    del spy
    log(f"phase programs: {time.perf_counter() - t:.2f} s")

    # the TPU gather probes S1-S7 and the device-entropy profile
    t = time.perf_counter()
    errs = check_probes(small_s, main_s[:BATCH], dev)
    records += drive_probes(main_s[:BATCH], dev, errs, smi)
    log(f"phase probes: {time.perf_counter() - t:.2f} s")

    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "JAX was imported")
    check(not any(m == "libjxl_tpu" or m.startswith("libjxl_tpu.")
                  for m in sys.modules), "the JAX package was imported")
    render_mp_s = BATCH * mp_per_image / (render_ms / 1e3)
    pipe_mp_s = len(main_s) * mp_per_image / t_pipe
    host_mp_s = BATCH * mp_per_image / t_host
    log(f"phase render-only (B={BATCH}, {SIZE}x{SIZE}, device-resident "
        f"inputs): {render_ms:.3f} ms, {render_mp_s:.2f} MP/s on {kind}; "
        f"peak device memory {peak_gb:.2f} GB")
    for label, parts in ((f"B={BATCH}, {SIZE}x{SIZE}", split),
                         (f"B={len(odd_s)}, {ODD_SIZE[1]}x{ODD_SIZE[0]}",
                          odd_split)):
        log(f"phase render split ({label}, CUDA events, mean of 5): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
            + f"; {smi}")
    log(f"phase pipelined end-to-end ({len(main_s)} streams, batch "
        f"{BATCH}): {t_pipe:.3f} s, {pipe_mp_s:.2f} MP/s on {kind}")
    log(f"phase host entropy + staging ({BATCH} streams): {t_host:.3f} s, "
        f"{host_mp_s:.2f} MP/s on the host of {kind}")
    ent_mp_s = len(main_s) * mp_per_image / t_ent
    log(f"phase device-entropy end-to-end ({len(main_s)} streams, batch "
        f"{BATCH}, decode_batch_entropy): {t_ent:.3f} s, {ent_mp_s:.2f} "
        f"MP/s on {kind}, beside pipelined host-entropy {pipe_mp_s:.2f} "
        f"MP/s")
    log("phase device-entropy stages (one batch of 16, host clock, device "
        "synchronized at each end): " + ", ".join(
            f"{k} {v * 1e3:.4f} ms" for k, v in stages.items()))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"paths": paths}), flush=True)
    print(json.dumps({"conformance_fuzz": paths["conformance_fuzz"]}),
          flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
