"""A multi-device dry run of the port: every sharded path once, each held
to its single-device form.

The counterpart of __graft_entry__.dryrun_multichip and its helpers
(_dryrun_real_sharded_decode, _dryrun_big_image_sharded_decode), run on a
parallel/sharding.Mesh in this process:

    python -m libjxl_tpu_torch.parallel.dryrun 8 cpu 0.25
    python -m libjxl_tpu_torch.parallel.dryrun 4 cuda  # 64 MP

With device="cuda" the mesh takes the cards in turn, so one card gives a
virtual mesh of n entries on cuda:0; device="cpu" gives n entries of the
CPU, where the kernels' plain twins run. big_mp replaces the JAX dry
run's GRAFT_BIG_MP environment variable.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..base.device import resolve_device
from ..ops import kernels, pipeline
from ..ops.staging import (block_sigma, dequant_tables, f32, gab_kernels,
                           sad_mul)
from ..vardct.quant_weights import library_tables
from .sharding import (GAB_KERNELS, Mesh, _put, build_sharded_decode,
                       build_sharded_decode_full, build_sharded_decode_stream,
                       build_sharded_encode, make_mesh, synchronize)


def mesh_devices(n: int, device) -> list:
    """n mesh entries on `device`: for "cuda" (no index) the cards in turn,
    cuda:i % count; otherwise n entries of that one device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        count = torch.cuda.device_count()
        return [torch.device("cuda", i % count) for i in range(n)]
    return [dev] * n


@dataclasses.dataclass
class StreamRender:
    """One XYB all-DCT8 stream's host-decoded state, staged for
    build_sharded_decode_stream: args are its global inputs (qimg, qf, dc,
    ytox, ytob, dm, inv_sigma_px, sad_mul; numpy), params its arguments
    after the mesh (lf, igs, xdm, bdm, gab_kernels, channel_scale)."""

    args: tuple
    params: tuple
    sigma: np.ndarray  # the EPF inverse sigma per block

    @classmethod
    def of(cls, stream: bytes, num_threads: int = 0) -> StreamRender:
        """Headers, DC and the AC entropy decode of `stream` on the host
        (api/tpu_codec's batch parse, one stream)."""
        from ..api import tpu_codec

        states, fhs = tpu_codec._parse([stream], num_threads=num_threads)
        st, lf = states[0], fhs[0].loop_filter
        tpu_codec._dense_qimg(st)
        h, w = st.fd.ysize_blocks * 8, st.fd.xsize_blocks * 8
        sigma = block_sigma(st, lf)
        args = (st.qimg.astype(np.int32, copy=False),
                st.raw_quant_field.astype(np.int32),
                st.dc.astype(np.float32), st.ytox_map.astype(np.int32),
                st.ytob_map.astype(np.int32), dequant_tables(st),
                np.repeat(np.repeat(sigma, 8, 0), 8, 1), sad_mul(lf, h, w))
        params = (lf, f32(st.quantizer.inv_global_scale), f32(st.x_dm_mult),
                  f32(st.b_dm_mult), gab_kernels(lf),
                  tuple(f32(v) for v in lf.epf_channel_scale))
        return cls(args, params, sigma)

    def on(self, dev) -> StreamRender:
        """The same inputs as tensors on dev (the renders then upload
        nothing)."""
        from ..ops.staging import to_device

        return StreamRender(to_device(self.args, dev), self.params,
                            to_device(self.sigma, dev))

    def sharded(self, mesh: Mesh):
        """The stream's sharded render: run(*args) -> u8[3, H, W]."""
        return build_sharded_decode_stream(mesh, *self.params)

    def single(self, dev) -> torch.Tensor:
        """The single-device render (pipeline.decode_render_image, the
        port's decode_tpu program) on dev, uploading what is not there
        yet: u8[H, W, 3]."""
        from ..ops.staging import to_device

        lf, igs, xdm, bdm, gab, chs = self.params
        qimg, qf, dc, ytox, ytob, dm, _, sad = to_device(self.args, dev)
        with torch.inference_mode():
            return pipeline.decode_render_image(
                qimg, qf, dc, ytox, ytob, dm, igs, xdm, bdm,
                to_device(gab, dev), to_device(self.sigma, dev), sad, chs,
                int(lf.epf_iters), to_rgb="u8srgb",
                pass0_sigma_scale=f32(lf.epf_pass0_sigma_scale),
                pass2_sigma_scale=f32(lf.epf_pass2_sigma_scale))


def u8_steps(got: np.ndarray, ref: np.ndarray, what: str):
    """(max steps, share of values that differ), raising unless within 1
    step and under 1e-3 of the values (the dry run's bound)."""
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    steps, frac = int(diff.max()), float((diff != 0).mean())
    if steps > 1 or frac >= 1e-3:
        raise RuntimeError(f"{what} diverged: max {steps} steps, "
                           f"fraction {frac:.2e}")
    return steps, frac


def _clock(devs):
    synchronize(devs)
    return time.perf_counter()


def photo(n: int, rng, freq=(0.02, 0.015), noise=9.0):
    """The JAX dry run's generator: an n x n smooth photo with noise."""
    yy, xx = np.mgrid[0:n, 0:n]
    base = (120 + 60 * np.sin(xx * freq[0]) + 50 * np.cos(yy * freq[1])
            + rng.normal(0, noise, (n, n)))
    return np.clip(np.stack([base, base * 0.9 + 12, base * 1.1 - 10], -1),
                   0, 255).astype(np.uint8)


def dryrun_real_sharded_decode(mesh: Mesh, device) -> dict:
    """A real 512x512 d1/e3 stream, entropy-decoded on the host, rendered
    with its rows sharded over the mesh's first row of devices, against
    the single-device render on `device` (within 1 step, under 1e-3 of
    the values)."""
    from ..api.codestream import encode_lossy

    stream = encode_lossy(photo(512, np.random.default_rng(7)),
                          distance=1.0, effort=3, device=None)
    sr = StreamRender.of(stream, num_threads=2)
    ref = sr.single(resolve_device(device)).cpu().numpy()
    got = sr.sharded(mesh)(*sr.args).cpu().numpy().transpose(1, 2, 0)
    if got.shape != ref.shape:
        raise RuntimeError(f"sharded real decode: {got.shape} vs "
                           f"{ref.shape}")
    steps, frac = u8_steps(got, ref, "sharded real decode")
    return {"steps": steps, "fraction": frac}


def dryrun_big_image_sharded_decode(devices, device, big_mp: float) -> dict:
    """ONE big image strip-sharded over every mesh entry: a photo of about
    big_mp megapixels (a side that is a multiple of 64 x the entries, so
    every band cuts at colour tiles and all bands are equal), encoded at
    d1/e3 on `device`, entropy-decoded on the host, rendered as row bands
    over a (1, n) mesh of `devices` against the whole-image render on
    `device` (within 1 step, under 1e-3 of the values). Prints the band
    balance and the strip program's time on a 1-entry mesh beside the
    n-entry one (host clock, devices synchronized)."""
    import os

    from ..api.codestream import encode_lossy

    n_dev = len(devices)
    unit = 64 * n_dev
    n = max(unit, int(round((big_mp * 1e6) ** 0.5 / unit)) * unit)
    img = photo(n, np.random.default_rng(64), freq=(0.0021, 0.0017),
                noise=5.0)
    t0 = time.perf_counter()
    stream = encode_lossy(img, distance=1.0, effort=3, device=device)
    t_enc = time.perf_counter() - t0
    del img
    t0 = time.perf_counter()
    sr = StreamRender.of(stream, num_threads=os.cpu_count() or 1)
    t_entropy = time.perf_counter() - t0
    h, w = sr.args[0].shape[-2:]
    dev = resolve_device(device)
    ref = sr.single(dev).cpu().numpy()
    t0 = _clock([dev])
    ref = sr.single(dev).cpu().numpy()
    t_single = _clock([dev]) - t0
    times = {}
    for label, devs in (("1", devices[:1]), (str(n_dev), devices)):
        run = sr.sharded(make_mesh(devs))
        run(*sr.args)
        t0 = _clock(devs)
        got = run(*sr.args).cpu().numpy()
        times[label] = _clock(devs) - t0
    steps, frac = u8_steps(got.transpose(1, 2, 0), ref,
                           "big-image sharded decode")
    overhead = times[str(n_dev)] / max(times["1"], 1e-9) - 1.0
    print(f"big-image shard: {w}x{h} ({w * h / 1e6:.1f} MP) over {n_dev} "
          f"bands of {h // n_dev} rows (balance exact) on "
          f"{[str(d) for d in devices]}; encode {t_enc:.2f} s, host "
          f"entropy {t_entropy:.2f} s; render whole-image "
          f"{t_single:.3f} s, strip program 1-entry {times['1']:.3f} s, "
          f"{n_dev}-entry {times[str(n_dev)]:.3f} s ({overhead * 100:+.1f}%"
          f"; host clock, devices synchronized)", flush=True)
    return {"side": n, "steps": steps, "fraction": frac,
            "encode_s": t_enc, "entropy_s": t_entropy,
            "whole_s": t_single, "strip_s": times}


BLOCK_DECODE_TOL = dict(rtol=1e-5, atol=1e-3)  # tests/test_tpu_pipeline.py


def dryrun_codec_step(mesh: Mesh, rng) -> dict:
    """The JAX dry run's first two steps on `mesh` (batch = its batch
    rows, 2 block rows a row shard, 8 block columns): the sharded encode
    of uniform RGB (build_sharded_encode; its shapes checked), then the
    block-layout decode of its coefficients with the Gaborish halo
    (build_sharded_decode, zero per-block-row CfL maps), held within
    BLOCK_DECODE_TOL to the unsharded decode on the mesh's first device:
    kernels.decode_pixels_hybrid of the whole batch (one dequant_idct8
    launch on a card, so the check isolates the sharding; the kernel's
    own check is against its twin) and a whole-image Gaborish."""
    batch, rows = mesh.devices.shape
    nby, nbx = rows * 2, 8
    h, w = nby * 8, nbx * 8
    dm, dm_inv = library_tables()[0]
    rgb = rng.uniform(0, 1, (batch, 3, h, w)).astype(np.float32)
    qf = np.full((batch, nby, nbx), 64, dtype=np.int32)
    inv_dc_mul = np.array([512.0, 64.0, 32.0], dtype=np.float32)
    dm_y = (1.0 / np.where(dm_inv[1] == 0, 1, dm_inv[1])).astype(np.float32)
    q, qdc = build_sharded_encode(mesh)(rgb, qf, dm_inv, dm_y, inv_dc_mul)
    if tuple(q.shape) != (batch, 3, nby, nbx, 8, 8) \
            or tuple(qdc.shape) != (batch, 3, nby, nbx):
        raise RuntimeError(f"sharded encode shapes {tuple(q.shape)}, "
                           f"{tuple(qdc.shape)}")

    dc = qdc.to(torch.float32)
    zeros = np.zeros((batch, nby, 1), dtype=np.int32)
    out = build_sharded_decode(mesh, apply_gab=True)(q, qf, dc, zeros,
                                                     zeros, dm)
    dev = mesh.first
    with torch.inference_mode():
        rgb = kernels.decode_pixels_hybrid(
            *(_put(a, dev) for a in (q, qf, dc, zeros, zeros, dm)), 1024.0)
        ref = pipeline.gaborish(rgb, GAB_KERNELS)
    if tuple(out.shape) != (batch, 3, h, w):
        raise RuntimeError(f"sharded block decode: shape {tuple(out.shape)}")
    err = float((out - ref).abs().max())
    if not torch.allclose(out, ref, **BLOCK_DECODE_TOL):
        raise RuntimeError(f"sharded block decode diverged from the "
                           f"unsharded decode: max abs err {err}")
    return {"encode_shapes": [list(q.shape), list(qdc.shape)],
            "block_decode": {"shape": list(out.shape), "max_abs_err": err}}


def dryrun_multichip(n_devices: int, device="cuda",
                     big_mp: float = 64.0) -> dict:
    """Every sharded path of the port once on an n_devices mesh
    (mesh_devices(n_devices, device), batch 2 when n_devices is even and
    at least 4), each checked: the sharded encode (its shapes) and the
    block-layout decode of its output (dryrun_codec_step), the full
    decode (its shape), the streaming encode with the mesh (bytes equal to the
    sequential encode's), a real 512x512 stream rendered sharded and ONE
    big image (big_mp megapixels) strip-sharded over every entry, each
    within 1 step of the single-device render, and the data-parallel
    serving decode (tpu_codec.decode_batch_sharded) within 1 step of the
    host decode. Raises on any failure; returns what it measured."""
    from ..api.codestream import decode, encode_lossy, encode_lossy_streaming
    from ..api.tpu_codec import decode_batch_sharded

    devices = mesh_devices(n_devices, device)
    batch = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(devices, batch=batch)
    rows = mesh.shape["rows"]
    rng = np.random.default_rng(1)
    nby, nbx = rows * 2, 8
    h, w = nby * 8, nbx * 8
    dm = library_tables()[0][0]
    qf = np.full((batch, nby, nbx), 64, dtype=np.int32)
    rec = {"mesh": repr(mesh)}

    # the encode step, RGB -> quantized coefficients + DC, and the
    # block-layout decode of them with the Gaborish halo exchange
    rec["codec_step"] = dryrun_codec_step(mesh, rng)

    # the full filter-chain decode, one block row of halo a seam
    qimg = rng.integers(-3, 4, (batch, 3, h, w)).astype(np.int32)
    dcf = rng.normal(0, 0.15, (batch, 3, nby, nbx)).astype(np.float32)
    zeros = np.zeros((batch, nby, nbx), np.int32)
    ispx = np.full((batch, h, w), 0.5, np.float32)
    sad = np.ones((batch, h, w), np.float32)
    out = build_sharded_decode_full(mesh, epf_iters=2)(
        qimg, qf, dcf, zeros, zeros, dm, ispx, sad)
    if tuple(out.shape) != (batch, 3, h, w) or not torch.isfinite(out).all():
        raise RuntimeError(f"sharded full decode: shape {tuple(out.shape)}"
                           " or a value that is not finite")

    # the streaming encode with the step sharded over the mesh rows: the
    # codestream must be the sequential encoder's, byte for byte
    img = np.clip(
        128 + 60 * np.sin(np.arange(320)[:, None] * 0.05)
        + 50 * np.cos(np.arange(256)[None, :] * 0.03)
        + rng.normal(0, 6, (320, 256)), 0, 255
    ).astype(np.uint8)[:, :, None].repeat(3, axis=2)
    seq = encode_lossy_streaming(img, distance=1.0, device=device)
    shd = encode_lossy_streaming(img, distance=1.0, mesh=mesh, device=device)
    if shd != seq:
        raise RuntimeError(f"sharded streaming encode diverged: {len(shd)} "
                           f"vs {len(seq)} bytes")
    got, _ = decode(shd, device=None)
    err = float(np.abs(got[:, :, :3].astype(np.int64)
                       - img.astype(np.int64)).mean())
    if err >= 8.0:
        raise RuntimeError(f"sharded streaming encode: mean error {err}")
    rec["streaming"] = {"bytes": len(shd), "mean_abs_err": err}

    rec["real"] = dryrun_real_sharded_decode(mesh, device)
    rec["big"] = dryrun_big_image_sharded_decode(devices, device, big_mp)

    # the data-parallel serving decode: one image a mesh entry
    streams, refs = [], []
    for i in range(n_devices):
        im = np.clip(
            120 + 50 * np.sin(np.arange(128)[:, None] * (0.03 + 0.002 * i))
            + rng.normal(0, 8, (128, 128)), 0, 255
        ).astype(np.uint8)[:, :, None].repeat(3, axis=2)
        s = encode_lossy(im, distance=1.0, effort=3, device=None)
        streams.append(s)
        refs.append(decode(s, device=None)[0])
    outs = decode_batch_sharded(streams, mesh=make_mesh(devices))
    steps = max(int(np.abs(ref[:, :, :3].astype(np.int16)
                           - got.astype(np.int16)).max())
                for ref, got in zip(refs, outs))
    if steps > 1:
        raise RuntimeError(f"sharded serving decode diverged: {steps} steps")
    rec["serving_steps"] = steps
    return rec


def main(argv=None) -> int:
    """python -m libjxl_tpu_torch.parallel.dryrun [n_devices [device
    [big_mp]]]: dryrun_multichip with those arguments (8, "cuda", 64 by
    default); prints its record as JSON."""
    import json
    import sys

    args = (sys.argv[1:] if argv is None else argv) + [None] * 3
    n = int(args[0] or 8)
    rec = dryrun_multichip(n, device=args[1] or "cuda",
                           big_mp=float(args[2] or 64.0))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
