"""The codec's compute path sharded over a mesh of devices, in one process.

The port of libjxl_tpu/parallel/sharding.py. The reference parallelizes
over the 256x256 group grid with a fork-join thread pool
(lib/jxl/base/data_parallel.h, enc_frame.cc:1382); the JAX package shards
the same grid over a jax.sharding.Mesh with two axes:

- "batch": independent images (data parallel);
- "rows": block-row stripes of one image. Gaborish and EPF read past a
  stripe's seam, so each stripe takes halo rows from its neighbours (the
  reference decoder's SaveBorders/LoadBorders strips,
  low_memory_render_pipeline.h:52-53).

Here a Mesh is an array of torch.device, and one Python process drives
every shard: each builder returns a callable that takes the JAX builder's
global arguments (numpy arrays or tensors on any device), slices each
shard's batch entries and rows, runs the shard's body on the shard's
device and concatenates the result on the mesh's first device. A device
may repeat in a mesh (four shards on cuda:0, eight on cpu): the shard
bodies and the halo bookkeeping are the same, and on several cards a halo
moves as a peer copy (Tensor.to, which PyTorch orders after the source's
and before the destination's current stream).

build_sharded_decode, the block-layout decode, runs one
kernels.decode_pixels_hybrid a shard (one dequant_idct8 launch) and,
after the exchange of one row of linear RGB with each neighbour, the
3x3 Gaborish blur (pipeline.gaborish of the shard and its halo rows, the
halo rows then dropped). It splits the per-tile CfL maps over "rows" as
the JAX builder does, and each shard expands its own maps from its own
tile 0, so it equals the unsharded decode only where every shard holds
whole 64-px colour tiles or the maps are zero (the JAX builder's fault,
kept).

The other decode bodies run the port's two render kernels a shard:
kernels.dequant_idct8 on the shard's own block rows, then, after the
exchange of one block row of XYB (ROW_HALO) with each neighbour,
kernels.render_tail on the composite. A whole block row keeps
render_tail's per-block sigma grid aligned, and it covers the filter
chain's reach (4 rows, 7 at epf_iters 3), so a shard's own rows come out
as the unsharded render gives them. The composite of the top and bottom
shard has no halo at the image edge: render_tail mirrors there, as it
does on the whole image (the JAX package's _edge_clamp_halo rebuilt that
mirror stage by stage). Every composite is new storage (torch.cat), so no
shard writes into a neighbour's tensor on a mesh that repeats a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base.device import resolve_device
from ..ops import kernels, pipeline
from ..ops.staging import per_block
from ..render.pipeline import gaborish_kernel

HALO = 3  # the JAX package's Gaborish + round-1 EPF halo (sharding.py:52)
GAB_DEFAULT = ((0.115169525, 0.061248592),) * 3  # 1.1 * defaults
GAB_KERNELS = np.stack([gaborish_kernel(*w) for w in GAB_DEFAULT]).astype(
    np.float32)
ROW_HALO = 8  # rows a decode shard takes from each neighbour: a block row
FULL_CHANNEL_SCALE = (40.0, 5.0, 3.5)  # build_sharded_decode_full's EPF


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices on a (batch, rows) grid, the counterpart of
    jax.sharding.Mesh: `devices` is a numpy object array of torch.device
    shaped (batch, rows); a device may repeat."""

    devices: np.ndarray
    axis_names: tuple = ("batch", "rows")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """Where the builders gather their results."""
        return self.devices.flat[0]

    @classmethod
    def of(cls, device, n: int, batch: int = 1) -> Mesh:
        """A mesh of `n` entries of one device (a virtual mesh), shaped as
        make_mesh shapes n devices."""
        return make_mesh([device] * n, batch=batch)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(devices=None, batch: int = 1) -> Mesh:
    """A (batch, rows) mesh over `devices` (torch devices or their names;
    a device may repeat), rows = len(devices) // batch; devices past
    batch * rows are left out, as the JAX package's make_mesh leaves them.
    The default is every CUDA card, cuda:0 to cuda:n-1; without a card it
    raises (a CPU mesh is built only by naming its devices)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA card; name the devices "
                               "to build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    rows = len(devices) // batch if batch > 0 else 0
    if rows < 1:
        raise ValueError(f"make_mesh: {len(devices)} devices cannot form "
                         f"{batch} batch rows")
    grid = np.empty((batch, rows), dtype=object)
    for i in range(batch * rows):
        grid.flat[i] = devices[i]
    return Mesh(grid)


def _part(n: int, parts: int, what: str, multiple: int = 1) -> int:
    """n // parts, raising where shard_map would refuse the shapes (or a
    shard would not hold a whole number of `multiple`s)."""
    if n % parts or (n // parts) % multiple:
        raise ValueError(f"{what}: {n} does not split into {parts} shards"
                         + (f" of a multiple of {multiple}"
                            if multiple > 1 else ""))
    return n // parts


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)) if not torch.is_tensor(a) else a


def _put(a, dev) -> torch.Tensor:
    """`a` (a numpy array or a tensor on any device) as a contiguous tensor
    on dev."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(dev, non_blocking=True).contiguous()


def _rows(a, axis: int, start: int, stop: int):
    return a[(slice(None),) * axis + (slice(start, stop),)]


def _halo_exchange_rows(shards, halo: int, edge: str | None = "replicate"):
    """The rows each row shard needs from its neighbours.

    shards: the row stripes of one image, in mesh order, each f32[...,
    rows_i, W] on its own device. Returns, for each shard, (above, below):
    the last `halo` rows of the shard above and the first `halo` rows of
    the shard below, placed on the shard's device. At the image's top and
    bottom, edge="replicate" repeats the shard's edge row `halo` times
    (the JAX package's _halo_exchange_rows); edge=None gives None there."""
    if any(s.shape[-2] < halo for s in shards):
        raise ValueError(f"halo exchange: a shard of "
                         f"{min(s.shape[-2] for s in shards)} rows cannot "
                         f"give {halo} halo rows")
    out = []
    last = len(shards) - 1
    for i, x in enumerate(shards):
        dev = x.device
        if i > 0:
            above = shards[i - 1][..., -halo:, :].to(dev, non_blocking=True)
        elif edge == "replicate":
            above = x[..., :1, :].repeat_interleave(halo, dim=-2)
        else:
            above = None
        if i < last:
            below = shards[i + 1][..., :halo, :].to(dev, non_blocking=True)
        elif edge == "replicate":
            below = x[..., -1:, :].repeat_interleave(halo, dim=-2)
        else:
            below = None
        out.append((above, below))
    return out


def _with_halo(shards, halo: int):
    """Each row shard with its neighbours' `halo` rows around it, none at
    the image edge, as new storage: [(composite, rows above it)]."""
    out = []
    for x, (above, below) in zip(shards,
                                 _halo_exchange_rows(shards, halo, None)):
        parts = [p for p in (above, x, below) if p is not None]
        out.append((torch.cat(parts, dim=-2), 0 if above is None else halo))
    return out


def _shared_map(sad_mul, what: str) -> torch.Tensor:
    """The SAD multiplier map f32[H, W] that render_tail shares across a
    batch; a [B, H, W] map must repeat one map."""
    sad = _tensor(sad_mul)
    if sad.dim() == 3:
        if not torch.equal(sad, sad[:1].expand_as(sad)):
            raise ValueError(f"{what}: sad_mul differs between images")
        sad = sad[0]
    return sad


def synchronize(devices) -> None:
    """Wait for every card among `devices`."""
    for dev in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def _decode_rows(devs, qimg, qf, dc, ytox, ytob, dm, igs, xdm, bdm,
                 sigma, sad, tail):
    """The shard bodies of the sharded decodes on one image group's row
    shards `devs`: dequant_idct8 of every shard's rows (queued on every
    device before any exchange), the ROW_HALO exchange, then tail(comp,
    inv_sigma, sad_mul) of each composite, cropped to the shard's rows.

    qimg i32/i16[..., 3, H, W], qf i32[..., nby, nbx], dc f32[..., 3, nby,
    nbx], ytox/ytob i32[..., nty, ntx] and sigma f32[..., nby, nbx] are
    global; the tile maps split evenly over the shards. igs: f32 per
    image; sad f32[H, W]. Returns the cropped tails in row order, each on
    its shard's device."""
    n = len(devs)
    h = qimg.shape[-2]
    rl = _part(h, n, "image rows", 8)
    tl = _part(ytox.shape[-2], n, "colour tile rows")
    bl = rl // 8
    xyb = []
    for r, dev in enumerate(devs):
        xyb.append(kernels.dequant_idct8(
            _put(_rows(qimg, qimg.ndim - 2, r * rl, (r + 1) * rl), dev),
            _put(_rows(qf, qf.ndim - 2, r * bl, (r + 1) * bl), dev),
            _put(_rows(dc, dc.ndim - 2, r * bl, (r + 1) * bl), dev),
            _put(_rows(ytox, ytox.ndim - 2, r * tl, (r + 1) * tl), dev),
            _put(_rows(ytob, ytob.ndim - 2, r * tl, (r + 1) * tl), dev),
            _put(dm, dev), _put(igs, dev), xdm, bdm))
    out = []
    for r, (comp, top) in enumerate(_with_halo(xyb, ROW_HALO)):
        dev = devs[r]
        y0 = r * rl - top  # the composite's first image row
        ch = comp.shape[-2]
        isg = _put(_rows(sigma, sigma.ndim - 2, y0 // 8, (y0 + ch) // 8),
                   dev)
        res = tail(comp, isg, _put(sad[y0:y0 + ch], dev))
        out.append((res, top, rl))
    return out


def _gather(parts, dev, dim: int) -> torch.Tensor:
    return torch.cat([p.to(dev, non_blocking=True) for p in parts], dim=dim)


def build_sharded_decode(mesh: Mesh, apply_gab: bool = True):
    """The block-layout decode sharded over (batch, rows): each mesh entry
    makes one kernels.decode_pixels_hybrid call (one dequant_idct8 launch
    on a card) for its images and block rows, at global scale 1024 and
    qm multipliers 1; with apply_gab, the exchange of one row of linear
    RGB with each row neighbour (edge rows replicated at the image's top
    and bottom) and the 3x3 Gaborish of GAB_DEFAULT (pipeline.gaborish,
    whose symmetric pad of 1 repeats the edge column as the JAX builder's
    edge pad does).

    Returns run(qcoeffs, qf, dc, ytox, ytob, dm) on the JAX builder's
    global inputs: qcoeffs i32[batch, 3, nby, nbx, 8, 8], qf i32[batch,
    nby, nbx], dc f32[batch, 3, nby, nbx], ytox/ytob i32[batch, tby, tbx],
    dm f32[3, 8, 8] replicated; batch over "batch", nby and tby over
    "rows" (the maps split as the block rows do: see the module's note).
    Gives linear RGB f32[batch, 3, nby*8, nbx*8] on the mesh's first
    device."""
    nb, nr = mesh.devices.shape

    def run(qcoeffs, qf, dc, ytox, ytob, dm):
        bl = _part(qcoeffs.shape[0], nb, "batch")
        rl = _part(qcoeffs.shape[2], nr, "block rows")
        tl = _part(ytox.shape[1], nr, "colour tile rows")
        out = []
        with torch.inference_mode():
            for b in range(nb):
                bs = slice(b * bl, (b + 1) * bl)
                rgb = []
                for r, dev in enumerate(mesh.devices[b]):
                    rs = slice(r * rl, (r + 1) * rl)
                    tr = slice(r * tl, (r + 1) * tl)
                    rgb.append(kernels.decode_pixels_hybrid(
                        _put(qcoeffs[bs, :, rs], dev),
                        _put(qf[bs, rs], dev), _put(dc[bs, :, rs], dev),
                        _put(ytox[bs, tr], dev), _put(ytob[bs, tr], dev),
                        _put(dm, dev), 1024.0, 1.0, 1.0))
                if apply_gab:
                    rgb = [pipeline.gaborish(torch.cat([above, x, below],
                                                       dim=-2),
                                             GAB_KERNELS)[..., 1:-1, :]
                           for x, (above, below) in zip(
                               rgb, _halo_exchange_rows(rgb, 1))]
                out.append(_gather(rgb, mesh.first, -2))
            return torch.cat(out)

    return run


def build_sharded_encode(mesh: Mesh):
    """The sharded encode compute, RGB -> quantized coefficients + DC
    (pipeline.encode_coefficients on every image of every shard, at global
    scale 1024 and qm multipliers 1).

    Returns run(rgb, qf, dm_inv, dm_y, inv_dc_mul): rgb f32[batch, 3, H,
    W] and qf i32[batch, nby, nbx] with the batch axis over "batch" and H
    over "rows"; dm_inv f32[3, 8, 8], dm_y f32[8, 8], inv_dc_mul f32[3]
    replicated. Gives (q i32[batch, 3, nby, nbx, 8, 8], qdc i32[batch, 3,
    nby, nbx]) on the mesh's first device."""
    nb, nr = mesh.devices.shape

    def run(rgb, qf, dm_inv, dm_y, inv_dc_mul):
        bl = _part(rgb.shape[0], nb, "batch")
        rl = _part(rgb.shape[-2], nr, "image rows", 8)
        qs, dcs = [], []
        with torch.inference_mode():
            for b in range(nb):
                row_q, row_dc = [], []
                for r in range(nr):
                    dev = mesh.devices[b, r]
                    x = _put(rgb[b * bl:(b + 1) * bl, :,
                                 r * rl:(r + 1) * rl], dev)
                    f = _put(qf[b * bl:(b + 1) * bl,
                                r * rl // 8:(r + 1) * rl // 8], dev)
                    tables = (_put(dm_inv, dev), _put(dm_y, dev))
                    idc = _put(inv_dc_mul, dev)
                    one = [pipeline.encode_coefficients(
                        x[i], f[i], *tables, 1024.0, 1.0, 1.0, idc)
                        for i in range(bl)]
                    row_q.append(torch.stack([o[0] for o in one]))
                    row_dc.append(torch.stack([o[1] for o in one]))
                qs.append(_gather(row_q, mesh.first, 2))
                dcs.append(_gather(row_dc, mesh.first, 2))
            return torch.cat(qs), torch.cat(dcs)

    return run


def build_sharded_decode_full(mesh: Mesh, epf_iters: int = 2):
    """The full decode sharded over (batch, rows): dequant + CfL + IDCT8
    (kernels.dequant_idct8), the ROW_HALO exchange, Gaborish with
    GAB_DEFAULT + the EPF passes of epf_iters (kernels.render_tail, XYB
    out), the crop, XYB -> linear RGB; global scale 1024, qm multipliers
    1, channel scale FULL_CHANNEL_SCALE.

    Returns run(qimg, qf, dc, ytox, ytob, dm, inv_sigma_px, sad_mul) on
    the JAX builder's global inputs: qimg i32[batch, 3, H, W], qf
    i32[batch, nby, nbx], dc f32[batch, 3, nby, nbx], ytox/ytob
    i32[batch, tby, tbx], dm f32[3, 8, 8], inv_sigma_px f32[batch, H, W]
    (constant on each 8x8 block) and sad_mul f32[batch, H, W] (one map
    for the batch) or [H, W]; batch over "batch", H, nby and tby over
    "rows". Gives f32[batch, 3, H, W] on the mesh's first device."""
    nb, nr = mesh.devices.shape

    def run(qimg, qf, dc, ytox, ytob, dm, inv_sigma_px, sad_mul):
        bl = _part(qimg.shape[0], nb, "batch")
        sigma = per_block(inv_sigma_px, "build_sharded_decode_full")
        sad = _shared_map(sad_mul, "build_sharded_decode_full")
        out = []
        with torch.inference_mode():
            for b in range(nb):
                devs = list(mesh.devices[b])
                bs = slice(b * bl, (b + 1) * bl)

                def tail(comp, isg, sd):
                    return kernels.render_tail(
                        comp, _put(GAB_KERNELS, comp.device), isg, sd,
                        FULL_CHANNEL_SCALE, epf_iters, out="xyb")

                shards = _decode_rows(
                    devs, qimg[bs], qf[bs], dc[bs], ytox[bs], ytob[bs], dm,
                    np.full(bl, 1024.0, dtype=np.float32), 1.0, 1.0,
                    sigma[bs], sad, tail)
                out.append(_gather(
                    [pipeline.xyb_to_rgb(x[..., top:top + rl, :])
                     for x, top, rl in shards], mesh.first, -2))
            return torch.cat(out)

    return run


def build_sharded_decode_stream(mesh: Mesh, lf, igs: float, xdm: float,
                                bdm: float, gab_kernels, channel_scale):
    """The device render of one real codestream's decoded state with its
    rows sharded: the math of pipeline.decode_render_image's all-DCT8 path
    to sRGB u8 (dequant_idct8, then render_tail with the stream's
    Gaborish kernels, EPF passes and sigma scales) with the ROW_HALO
    exchange between them. A mesh with more than one batch row uses its
    first row of devices.

    Returns run(qimg, qf, dc, ytox, ytob, dm, inv_sigma_px, sad_mul) on
    the JAX builder's global inputs, one image: qimg i32[3, H, W], qf
    i32[nby, nbx], dc f32[3, nby, nbx], ytox/ytob i32[tby, tbx], dm f32[3,
    8, 8], inv_sigma_px and sad_mul f32[H, W]; H sharded at 64-px colour
    tile boundaries. Gives u8[3, H, W] on the mesh's first device (the
    JAX output spec P(None, "rows", None))."""
    devs = list(mesh.devices[0])
    epf_iters = int(lf.epf_iters)
    gab = np.asarray(gab_kernels, dtype=np.float32) if lf.gab else None
    p0 = float(lf.epf_pass0_sigma_scale)
    p2 = float(lf.epf_pass2_sigma_scale)
    igs = np.float32(igs).reshape(1)

    def tail(comp, isg, sd):
        return kernels.render_tail(
            comp, None if gab is None else _put(gab, comp.device), isg, sd,
            channel_scale, epf_iters, p0, p2, out="u8srgb")

    def run(qimg, qf, dc, ytox, ytob, dm, inv_sigma_px, sad_mul):
        _part(qimg.shape[-2], len(devs), "image rows",
              8 * pipeline.COLOR_TILE_BLOCKS)
        sigma = per_block(inv_sigma_px, "build_sharded_decode_stream")
        with torch.inference_mode():
            shards = _decode_rows(devs, qimg, qf, dc, ytox, ytob, dm, igs,
                                  xdm, bdm, sigma, _tensor(sad_mul), tail)
            return _gather([u8[top:top + rl].permute(2, 0, 1)
                            for u8, top, rl in shards], mesh.first, 1)

    return run


def make_sharded_chunk_step(mesh: Mesh):
    """The streaming encoder's per-DC-group step (pipeline.encode_step_xyb)
    with its rows sharded over the mesh's first row of devices, the
    multi-device encode decomposition (enc_frame.cc:1975
    EncodeFrameStreaming).

    Every op of the step is row-local at 64-row granularity (DCT blocks,
    64-px CfL tiles; the quant field comes from the host), so each
    shard's outputs are the single-device step's rows of them, and the
    bytes the host entropy coder writes are the sequential encoder's.

    Returns step(xyb, dm_inv, dm, inv_global_scale, base_quant, x_dm_mult,
    b_dm_mult, qf_in), vardct/streaming.step's contract without the
    device: xyb f32[3, h, w] with h sharded at colour tile boundaries;
    numpy (q, dc, qf, ytox, ytob, sharp), read back after every device
    has finished."""
    devs = list(mesh.devices[0])

    def step(xyb, dm_inv, dm, inv_global_scale, base_quant, x_dm_mult,
             b_dm_mult, qf_in):
        rl = _part(xyb.shape[-2], len(devs), "DC group rows",
                   8 * pipeline.COLOR_TILE_BLOCKS)
        bl = rl // 8
        outs = []
        with torch.inference_mode():
            for r, dev in enumerate(devs):
                outs.append(pipeline.encode_step_xyb(
                    _put(xyb[:, r * rl:(r + 1) * rl], dev), _put(dm_inv, dev),
                    _put(dm, dev), inv_global_scale, base_quant, x_dm_mult,
                    b_dm_mult, qf_in=_put(qf_in[r * bl:(r + 1) * bl], dev)))
            synchronize(devs)
            # q and dc carry the block rows on axis 1, the maps on axis 0
            return tuple(
                np.concatenate([o[k].cpu().numpy() for o in outs],
                               axis=1 if k < 2 else 0)
                for k in range(6))

    return step
