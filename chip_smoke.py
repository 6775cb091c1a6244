#!/usr/bin/env python3
"""GPU smoke run of libjxl_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (on PATH or in CUDA_HOME, default
/usr/local/cuda) and a C compiler; no network, no JAX, and nothing of the
JAX package libjxl_tpu: the port carries its own host layers. It

1. builds the port's native host library (libjxl_tpu_torch/native) and
   its CUDA kernels from libjxl_tpu_torch/ops/csrc;
2. encodes distinct streams with the port's host encoder (a process
   pool): 32 photo-like 2048x2048 at d1/e3 with the encoder's default EPF
   (2 passes), 4 at 2048x2048 with epf=3 (the 12-neighbour pass), 2 at
   1021x765 (the true-size mirror); each is also decoded by the port's
   host decode, the reference; and two 512x512 d4 streams
   (tests/test_ans_kernel.py's generator);
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
   16-stream batches, with the counters reset just before, and times its
   stages on one batch;
7. checks every image against the host decode (at most 1 u8 step), the
   pipelined output against the batched and the device-entropy outputs
   (exactly), and the launch counts (dequant_idct8 and render_tail once
   a batch on every path, ans_decode once a device-entropy batch);
8. holds every probe kernel (the TPU gather probes S1-S7,
   libjxl_tpu_torch/probes) against its twin, exactly, then drives the
   probes with the counters reset just before: every S1-S5 form timed
   at its TPU probe's step count (ns per lane-step, the marginal cost
   t(5n) - t(n) over 4n) beside its twin, S6's 560 no-op launches eager
   and from a CUDA graph, and S7's profile of the device-entropy stages
   on the first 16-stream batch (the stream-copy floor, ans_decode's
   cost a step and fixed cost, the tape fill, place's pieces).

It prints the phase seconds, the rates (render-only, pipelined
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


def encode_and_reference(job):
    """Pool worker: (h, w, seed, epf) -> (stream, host-decoded u8 RGB);
    epf "small" makes a 512x512 d4 stream of small_image instead."""
    from libjxl_tpu_torch.api import codestream

    h, w, seed, epf = job
    if epf == "small":
        stream = codestream.encode_lossy(small_image(h, seed), distance=4.0,
                                         effort=3)
    else:
        stream = codestream.encode_lossy(make_image(h, w, seed),
                                         distance=1.0, effort=3, epf=epf)
    ref = codestream.decode(stream)[0][:, :, :3]
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


def render_split(renderer, inputs, reps=5):
    """BatchRenderer.forward's kernels and the mirror between them, each
    timed by CUDA events over `reps` renders after one warm-up: {stage:
    mean ms}. The calls are decode_render_image's."""
    import torch

    from libjxl_tpu_torch.ops import kernels, pipeline

    c = renderer.config
    qimg, qf, dc, ytox, ytob, igs, isg = inputs
    names = ("dequant_idct8", "true-size mirror", "render_tail")
    total = dict.fromkeys(names, 0.0)
    with torch.inference_mode():
        for rep in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            xyb = kernels.dequant_idct8(qimg, qf, dc, ytox, ytob,
                                        renderer.dm, igs, c.x_dm_mult,
                                        c.b_dm_mult)
            ev[1].record()
            if c.true_size is not None:
                pipeline.mirror_to_true_size(xyb, c.true_size)
            ev[2].record()
            kernels.render_tail(
                xyb, renderer.gab_kernels if c.gab else None, isg,
                renderer.sad_mul, c.channel_scale, c.epf_iters,
                c.pass0_sigma_scale, c.pass2_sigma_scale, out="u8srgb")
            ev[3].record()
            torch.cuda.synchronize()
            if rep:
                for name, a, b in zip(names, ev, ev[1:]):
                    total[name] += a.elapsed_time(b) / reps
    return total


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
        f"{t_plan:.3f} s, ans_decode {k3_ms:.3f} ms, place {place_ms:.3f} "
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
            "ms_on_plain_input": small_ms, "place_ms": place_ms}


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a GPU",
              file=sys.stderr)
        return 1
    from libjxl_tpu_torch import native_ext
    from libjxl_tpu_torch.api import tpu_codec
    from libjxl_tpu_torch.base.device import (card_line,
                                              reset_launch_counts,
                                              resolve_device)
    from libjxl_tpu_torch.ops import build

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

    import concurrent.futures as cf
    import multiprocessing as mp

    jobs = ([(SIZE, SIZE, 100 + i, None) for i in range(2 * BATCH)]
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
    streams = [s for s, _ in done]
    refs = [r for _, r in done]
    check(len(set(streams)) == len(streams), "streams are not distinct")
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
    outs, n = counted(tpu_codec.decode_batch, odd_s, dev)
    check(n == RENDER_LAUNCHES, f"1021x765 decode_batch launches {n}")
    check_images(outs, odd_r, "decode_batch 1021x765 (true-size mirror)")
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
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
