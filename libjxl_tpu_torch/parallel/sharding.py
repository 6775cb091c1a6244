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

Each shard body runs as programs (ops/programs.py), the counterpart of
the JAX builders' jax.jit: one a mesh entry and phase, on the entry's
device, keyed by the builder's own arguments, the phase and the entry
(b, r). A builder without an exchange (build_sharded_encode,
make_sharded_chunk_step) has one phase; a decode builder two, phase 1
the decode of the entry's rows, phase 2 the filters on the composite. The
exchange runs between the two (a capture may not allocate on another
card), and the gather onto the mesh's first device after them.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..base.device import resolve_device
from ..ops import kernels, pipeline, programs
from ..ops.staging import per_block
from ..render.pipeline import gaborish_kernel

HALO = 3  # the JAX package's Gaborish + round-1 EPF halo (sharding.py:52)
GAB_DEFAULT = ((0.115169525, 0.061248592),) * 3  # 1.1 * defaults
GAB_KERNELS = np.stack([gaborish_kernel(*w) for w in GAB_DEFAULT]).astype(
    np.float32)
ROW_HALO = 8  # rows a decode shard takes from each neighbour: a block row
FULL_CHANNEL_SCALE = (40.0, 5.0, 3.5)  # build_sharded_decode_full's EPF
# one builder call at a time: a call hands its programs' own outputs from
# one phase to the next (programs.run clone=False)
_RUN_LOCK = threading.Lock()


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


def _contiguous(*tensors):
    return tuple(None if t is None else t.contiguous() for t in tensors)


def _entry(name, key, fn, dev, *args, **kwargs):
    """fn(*args, **kwargs) through the program (name, key) on one mesh
    entry's device, its outputs the program's own (clone=False): the
    builder consumes them (the next phase reads them in place, or the
    gather copies them) before the program runs again, under
    _RUN_LOCK."""
    return programs.run(name, key, fn, *args, device=dev, clone=False,
                        **kwargs)


def _k1_rows(qimg, qf, dc, ytox, ytob, dm, igs, xdm, bdm):
    """Phase 1 of the image-layout decode builders: dequant_idct8 of one
    mesh entry's rows."""
    return kernels.dequant_idct8(*_contiguous(qimg, qf, dc, ytox, ytob, dm,
                                              igs), xdm, bdm)


def _composite(above, x, below):
    """A row shard with the halo rows its neighbours gave it
    (_halo_exchange_rows; None at the image edge), as new storage."""
    return torch.cat([p for p in (above, x, below) if p is not None],
                     dim=-2)


def _decode_rows(name, key, b, devs, qimg, qf, dc, ytox, ytob, dm, igs,
                 xdm, bdm, sigma, sad, tail, **tail_kw):
    """The sharded decodes on the row shards `devs` of one image group,
    mesh row b, as two programs a mesh entry (b, r), keyed key + (phase,
    (b, r)): phase 1 (_k1_rows) runs dequant_idct8 on every entry's rows
    (queued on every device before any exchange); the ROW_HALO rows of
    each neighbour's phase-1 output are then copied into phase 2's input
    slots (a peer copy between cards); phase 2 (tail) reads the entry's
    own rows where its phase 1 wrote them, builds the composite, runs
    render_tail and crops it to the entry's rows: tail(above, x, below,
    inv_sigma, sad_mul, top=, rows=, **tail_kw).

    qimg i32/i16[..., 3, H, W], qf i32[..., nby, nbx], dc f32[..., 3, nby,
    nbx], ytox/ytob i32[..., nty, ntx] and sigma f32[..., nby, nbx] are
    global; the tile maps split evenly over the shards. igs: f32 per
    image; sad f32[H, W]. Returns phase 2's outputs in row order, each on
    its entry's device (the program's own tensors)."""
    n = len(devs)
    h = qimg.shape[-2]
    rl = _part(h, n, "image rows", 8)
    tl = _part(ytox.shape[-2], n, "colour tile rows")
    bl = rl // 8
    xyb = [_entry(name, key + (1, (b, r)), _k1_rows, dev,
                  _rows(qimg, qimg.ndim - 2, r * rl, (r + 1) * rl),
                  _rows(qf, qf.ndim - 2, r * bl, (r + 1) * bl),
                  _rows(dc, dc.ndim - 2, r * bl, (r + 1) * bl),
                  _rows(ytox, ytox.ndim - 2, r * tl, (r + 1) * tl),
                  _rows(ytob, ytob.ndim - 2, r * tl, (r + 1) * tl),
                  dm, igs, xdm=float(xdm), bdm=float(bdm))
           for r, dev in enumerate(devs)]
    out = []
    for r, (dev, (above, below)) in enumerate(zip(
            devs, _halo_exchange_rows(xyb, ROW_HALO, None))):
        top = 0 if above is None else ROW_HALO
        y0 = r * rl - top  # the composite's first image row
        y1 = (r + 1) * rl + (0 if below is None else ROW_HALO)
        out.append(_entry(name, key + (2, (b, r)), tail, dev, above, xyb[r],
                          below, _rows(sigma, sigma.ndim - 2, y0 // 8,
                                       y1 // 8), sad[y0:y1], top=top,
                          rows=rl, **tail_kw))
    return out


def _gather(parts, dev, dim: int) -> torch.Tensor:
    return torch.cat([p.to(dev, non_blocking=True) for p in parts], dim=dim)


def _hybrid_rows(qcoeffs, qf, dc, ytox, ytob, dm, igs):
    """Phase 1 of build_sharded_decode: kernels.decode_pixels_hybrid of
    one mesh entry's images and block rows at global scale 1024 (the
    "dec" program's body, since a program cannot call another)."""
    args = _contiguous(qcoeffs, qf, dc, ytox, ytob, dm)
    if qcoeffs.device.type == "cpu":
        return kernels.decode_pixels_hybrid(*args, 1024.0)
    return kernels._pixels_program(*args, igs, 1.0, 1.0)


def _gab_rows(above, x, below):
    """Phase 2 of build_sharded_decode: the 3x3 Gaborish of GAB_DEFAULT on
    one row shard of linear RGB and a row of each neighbour (its own edge
    row at the image's top and bottom), those rows then dropped."""
    gab = programs.constant("sharding_gab_default", x.device,
                            lambda: GAB_KERNELS)
    return pipeline.gaborish(_composite(above, x, below), gab)[..., 1:-1, :]


def build_sharded_decode(mesh: Mesh, apply_gab: bool = True):
    """The block-layout decode sharded over (batch, rows): each mesh entry
    makes one decode_pixels_hybrid call (one dequant_idct8 launch on a
    card) for its images and block rows, at global scale 1024 and qm
    multipliers 1; with apply_gab, the exchange of one row of linear RGB
    with each row neighbour (edge rows replicated at the image's top and
    bottom) and the 3x3 Gaborish of GAB_DEFAULT (pipeline.gaborish,
    whose symmetric pad of 1 repeats the edge column as the JAX builder's
    edge pad does).

    Programs (the JAX builder is one jitted program): "sharded_decode"
    keyed (apply_gab, phase, (b, r)) a mesh entry (b, r); phase 1 the
    decode, phase 2 (with apply_gab) the Gaborish, its halo rows copied
    into its slots between the two.

    Returns run(qcoeffs, qf, dc, ytox, ytob, dm) on the JAX builder's
    global inputs: qcoeffs i32[batch, 3, nby, nbx, 8, 8], qf i32[batch,
    nby, nbx], dc f32[batch, 3, nby, nbx], ytox/ytob i32[batch, tby, tbx],
    dm f32[3, 8, 8] replicated; batch over "batch", nby and tby over
    "rows" (the maps split as the block rows do: see the module's note).
    Gives linear RGB f32[batch, 3, nby*8, nbx*8] on the mesh's first
    device."""
    nb, nr = mesh.devices.shape
    igs = np.asarray(1024.0, dtype=np.float32)

    def run(qcoeffs, qf, dc, ytox, ytob, dm):
        bl = _part(qcoeffs.shape[0], nb, "batch")
        rl = _part(qcoeffs.shape[2], nr, "block rows")
        tl = _part(ytox.shape[1], nr, "colour tile rows")
        out = []
        with _RUN_LOCK, torch.inference_mode():
            for b in range(nb):
                bs = slice(b * bl, (b + 1) * bl)
                devs = mesh.devices[b]
                rgb = [_entry(
                    "sharded_decode", (apply_gab, 1, (b, r)), _hybrid_rows,
                    dev, qcoeffs[bs, :, r * rl:(r + 1) * rl],
                    qf[bs, r * rl:(r + 1) * rl],
                    dc[bs, :, r * rl:(r + 1) * rl],
                    ytox[bs, r * tl:(r + 1) * tl],
                    ytob[bs, r * tl:(r + 1) * tl], dm, igs)
                    for r, dev in enumerate(devs)]
                if apply_gab:
                    rgb = [_entry(
                        "sharded_decode", (apply_gab, 2, (b, r)), _gab_rows,
                        dev, above, x, below)
                        for r, (dev, x, (above, below)) in enumerate(zip(
                            devs, rgb, _halo_exchange_rows(rgb, 1)))]
                out.append(_gather(rgb, mesh.first, -2))
            return torch.cat(out)

    return run


def _encode_rows(rgb, qf, dm_inv, dm_y, igs, inv_dc_mul):
    """build_sharded_encode's program: encode_coefficients of each image
    of one mesh entry's rows."""
    one = [pipeline.encode_coefficients(x, f, dm_inv, dm_y, igs, 1.0, 1.0,
                                        inv_dc_mul)
           for x, f in zip(rgb.contiguous(), qf.contiguous())]
    return (torch.stack([o[0] for o in one]),
            torch.stack([o[1] for o in one]))


def build_sharded_encode(mesh: Mesh):
    """The sharded encode compute, RGB -> quantized coefficients + DC
    (pipeline.encode_coefficients on every image of every shard, at global
    scale 1024 and qm multipliers 1): one "sharded_encode" program a mesh
    entry (b, r), keyed (1, (b, r)); no exchange.

    Returns run(rgb, qf, dm_inv, dm_y, inv_dc_mul): rgb f32[batch, 3, H,
    W] and qf i32[batch, nby, nbx] with the batch axis over "batch" and H
    over "rows"; dm_inv f32[3, 8, 8], dm_y f32[8, 8], inv_dc_mul f32[3]
    replicated. Gives (q i32[batch, 3, nby, nbx, 8, 8], qdc i32[batch, 3,
    nby, nbx]) on the mesh's first device."""
    nb, nr = mesh.devices.shape
    igs = np.asarray(1024.0, dtype=np.float32)

    def run(rgb, qf, dm_inv, dm_y, inv_dc_mul):
        bl = _part(rgb.shape[0], nb, "batch")
        rl = _part(rgb.shape[-2], nr, "image rows", 8)
        qs, dcs = [], []
        with _RUN_LOCK, torch.inference_mode():
            for b in range(nb):
                bs = slice(b * bl, (b + 1) * bl)
                outs = [_entry(
                    "sharded_encode", (1, (b, r)), _encode_rows,
                    mesh.devices[b, r], rgb[bs, :, r * rl:(r + 1) * rl],
                    qf[bs, r * rl // 8:(r + 1) * rl // 8], dm_inv, dm_y, igs,
                    inv_dc_mul) for r in range(nr)]
                qs.append(_gather([o[0] for o in outs], mesh.first, 2))
                dcs.append(_gather([o[1] for o in outs], mesh.first, 2))
            return torch.cat(qs), torch.cat(dcs)

    return run


def _full_tail(above, x, below, inv_sigma, sad_mul, top, rows, epf_iters):
    """Phase 2 of build_sharded_decode_full: Gaborish with GAB_DEFAULT and
    the EPF passes (render_tail, XYB out) on the composite, the entry's
    rows, XYB -> linear RGB."""
    comp = _composite(above, x, below)
    gab = programs.constant("sharding_gab_default", x.device,
                            lambda: GAB_KERNELS)
    res = kernels.render_tail(comp, gab, *_contiguous(inv_sigma, sad_mul),
                              FULL_CHANNEL_SCALE, epf_iters, out="xyb")
    return pipeline.xyb_to_rgb(res[..., top:top + rows, :])


def build_sharded_decode_full(mesh: Mesh, epf_iters: int = 2):
    """The full decode sharded over (batch, rows): dequant + CfL + IDCT8
    (kernels.dequant_idct8), the ROW_HALO exchange, Gaborish with
    GAB_DEFAULT + the EPF passes of epf_iters (kernels.render_tail, XYB
    out), the crop, XYB -> linear RGB; global scale 1024, qm multipliers
    1, channel scale FULL_CHANNEL_SCALE. Programs: "sharded_full" keyed
    (epf_iters, phase, (b, r)) a mesh entry (b, r), phases as _decode_rows
    runs them.

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
        with _RUN_LOCK, torch.inference_mode():
            for b in range(nb):
                bs = slice(b * bl, (b + 1) * bl)
                shards = _decode_rows(
                    "sharded_full", (int(epf_iters),), b,
                    list(mesh.devices[b]), qimg[bs], qf[bs], dc[bs],
                    ytox[bs], ytob[bs], dm,
                    np.full(bl, 1024.0, dtype=np.float32), 1.0, 1.0,
                    sigma[bs], sad, _full_tail, epf_iters=int(epf_iters))
                out.append(_gather(shards, mesh.first, -2))
            return torch.cat(out)

    return run


def _stream_tail(above, x, below, inv_sigma, sad_mul, gab, top, rows,
                 channel_scale, epf_iters, pass0_sigma_scale,
                 pass2_sigma_scale):
    """Phase 2 of build_sharded_decode_stream: render_tail with the
    stream's Gaborish kernels (or none), EPF passes and sigma scales on
    the composite, sRGB u8 out, the entry's rows as u8[3, rows, W]."""
    u8 = kernels.render_tail(
        _composite(above, x, below), None if gab is None else gab.contiguous(),
        *_contiguous(inv_sigma, sad_mul), channel_scale, epf_iters,
        pass0_sigma_scale, pass2_sigma_scale, out="u8srgb")
    return u8[top:top + rows].permute(2, 0, 1)


def build_sharded_decode_stream(mesh: Mesh, lf, igs: float, xdm: float,
                                bdm: float, gab_kernels, channel_scale):
    """The device render of one real codestream's decoded state with its
    rows sharded: the math of pipeline.decode_render_image's all-DCT8 path
    to sRGB u8 (dequant_idct8, then render_tail with the stream's
    Gaborish kernels, EPF passes and sigma scales) with the ROW_HALO
    exchange between them. A mesh with more than one batch row uses its
    first row of devices. Programs: "sharded_stream" keyed by the loop
    filter's fields (Gaborish on, epf_iters, the two sigma scales, the
    channel scale), igs, xdm, bdm, then the phase and the entry (0, r),
    phases as _decode_rows runs them.

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
    channel_scale = tuple(float(c) for c in channel_scale)
    key = (bool(lf.gab), epf_iters, p0, p2, channel_scale, float(igs),
           float(xdm), float(bdm))
    igs = np.float32(igs).reshape(1)

    def run(qimg, qf, dc, ytox, ytob, dm, inv_sigma_px, sad_mul):
        _part(qimg.shape[-2], len(devs), "image rows",
              8 * pipeline.COLOR_TILE_BLOCKS)
        sigma = per_block(inv_sigma_px, "build_sharded_decode_stream")
        with _RUN_LOCK, torch.inference_mode():
            shards = _decode_rows(
                "sharded_stream", key, 0, devs, qimg, qf, dc, ytox, ytob, dm,
                igs, xdm, bdm, sigma, _tensor(sad_mul), _stream_tail,
                gab=gab, channel_scale=channel_scale, epf_iters=epf_iters,
                pass0_sigma_scale=p0, pass2_sigma_scale=p2)
            return _gather(shards, mesh.first, 1)

    return run


def make_sharded_chunk_step(mesh: Mesh):
    """The streaming encoder's per-DC-group step (pipeline.encode_step_xyb)
    with its rows sharded over the mesh's first row of devices, the
    multi-device encode decomposition (enc_frame.cc:1975
    EncodeFrameStreaming): one "sharded_chunk" program a mesh entry (0,
    r), keyed (1, (0, r)), the single-device step's body (vardct/streaming
    _step_program); no exchange.

    Every op of the step is row-local at 64-row granularity (DCT blocks,
    64-px CfL tiles; the quant field comes from the host), so each
    shard's outputs are the single-device step's rows of them, and the
    bytes the host entropy coder writes are the sequential encoder's.

    Returns step(xyb, dm_inv, dm, inv_global_scale, base_quant, x_dm_mult,
    b_dm_mult, qf_in), vardct/streaming.step's contract without the
    device: xyb f32[3, h, w] with h sharded at colour tile boundaries;
    numpy (q, dc, qf, ytox, ytob, sharp), read back after every device
    has finished."""
    from ..vardct.streaming import _step_program

    devs = list(mesh.devices[0])

    def step(xyb, dm_inv, dm, inv_global_scale, base_quant, x_dm_mult,
             b_dm_mult, qf_in):
        rl = _part(xyb.shape[-2], len(devs), "DC group rows",
                   8 * pipeline.COLOR_TILE_BLOCKS)
        bl = rl // 8
        scalars = tuple(float(v) for v in (inv_global_scale, base_quant,
                                           x_dm_mult, b_dm_mult))
        with _RUN_LOCK, torch.inference_mode():
            outs = [_entry("sharded_chunk", (1, (0, r)), _step_program, dev,
                           xyb[:, r * rl:(r + 1) * rl], dm_inv, dm,
                           qf_in[r * bl:(r + 1) * bl], *scalars)
                    for r, dev in enumerate(devs)]
            synchronize(devs)
            # q and dc carry the block rows on axis 1, the maps on axis 0
            return tuple(
                np.concatenate([o[k].cpu().numpy() for o in outs],
                               axis=1 if k < 2 else 0)
                for k in range(6))

    return step
