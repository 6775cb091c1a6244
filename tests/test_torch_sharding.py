"""libjxl_tpu_torch's multi-device path (parallel/sharding.py, the sharded
streaming encode, tpu_codec.decode_batch_sharded, parallel/dryrun.py)
against the JAX package's on the CPU: the JAX side shards over the 8
virtual CPU devices of tests/conftest.py, the port over a mesh of 8 x
"cpu", where the kernels' plain twins run the same shard bodies.

Bounds: the halo exchange, the sharded encode and the port's sharded
renders against its own unsharded ones are exact. The full decode's
linear RGB is held to the JAX builder's at rtol 1e-5 / atol 2e-5
(tests/test_torch_device_render.py) on the XYB it is computed from,
carried through the colour transform's cubes (_rgb_tol): the port's IDCT
sums in another order, and on these random coefficients (every AC
position in [-3, 3]) one value in 50,000 moves past the bound taken on
the RGB itself. u8 output is held within 1 step (under 1e-3 of the
values differ) of the JAX package's. The streaming bytes equal the port's
sequential bytes; against the JAX package's they differ by boundary flips
(tests/test_torch_streaming.py), so the sharded step is held to the JAX
sharded step by tests/test_torch_encode.py's boundary rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P
from test_sharded_full import _inputs
from test_torch_encode import TOL as ENC_TOL
from test_torch_encode import _assert_step

from libjxl_tpu.api import codestream as jcs
from libjxl_tpu.api import tpu_codec as jtc
from libjxl_tpu.ops import pipeline as jpl
from libjxl_tpu.parallel import sharding as js
from libjxl_tpu.render.pipeline import gaborish_kernel
from libjxl_tpu.vardct.quant_weights import library_tables
from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.api import tpu_codec as ttc
from libjxl_tpu_torch.base.device import launch_counts
from libjxl_tpu_torch.base.status import JXLError
from libjxl_tpu_torch.ops import pipeline as tpl
from libjxl_tpu_torch.parallel import dryrun
from libjxl_tpu_torch.parallel import sharding as ts

TOL = dict(rtol=1e-5, atol=2e-5)


def _jmesh(n, batch):
    return js.make_mesh(jax.devices()[:n], batch=batch)


def _cat_halo(shards, halo, edge="replicate"):
    return torch.cat([torch.cat([p for p in (a, s, b) if p is not None],
                                dim=-2)
                      for s, (a, b) in zip(shards, ts._halo_exchange_rows(
                          shards, halo, edge))], dim=-2)


# ------------------------------------------------------------- the mesh

def test_mesh_has_the_jax_meshes_shape():
    for n, batch in ((8, 1), (8, 2), (6, 4)):
        mesh = ts.Mesh.of("cpu", n, batch=batch)
        assert mesh.shape == dict(_jmesh(n, batch).shape)
        assert mesh.devices.shape == _jmesh(n, batch).devices.shape
        assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert ts.make_mesh(["cpu", torch.device("cpu")]).shape == {
        "batch": 1, "rows": 2}
    with pytest.raises(ValueError, match="cannot form"):
        ts.make_mesh(["cpu"] * 3, batch=4)


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ts.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.make_mesh(["cuda:0"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttc.decode_batch_sharded([b"unused"])


# ------------------------------------------------------ the halo exchange

@pytest.mark.parametrize("rows", [2, 4, 8])
@pytest.mark.parametrize("halo", [1, 4, 8])
def test_halo_exchange_matches_the_jax_exchange(halo, rows):
    """Each shard with its neighbours' rows, edge-replicated at the image
    boundary, as JAX's _halo_exchange_rows gives it under shard_map."""
    local = 8
    x = np.random.default_rng(10 * rows + halo).normal(
        size=(2, rows * local, 16)).astype(np.float32)
    mesh = JMesh(np.array(jax.devices()[:rows]), ("rows",))
    ref = jax.jit(js._shard_map(
        lambda a: js._halo_exchange_rows(a, halo, "rows"), mesh,
        (P(None, "rows", None),), P(None, "rows", None)))(x)
    shards = [torch.from_numpy(x[:, r * local:(r + 1) * local])
              for r in range(rows)]
    np.testing.assert_array_equal(_cat_halo(shards, halo).numpy(),
                                  np.asarray(ref))
    # without edge rows: the composites the shard bodies render
    got = ts._with_halo(shards, halo)
    assert [top for _, top in got] == [0] + [halo] * (rows - 1)
    whole = torch.from_numpy(x)
    for r, (comp, top) in enumerate(got):
        y0 = r * local - top
        assert torch.equal(comp, whole[:, y0:y0 + comp.shape[-2]])


def test_halo_exchange_needs_a_whole_halo_a_shard():
    shards = [torch.zeros(3, 4, 8), torch.zeros(3, 4, 8)]
    with pytest.raises(ValueError, match="cannot give 8 halo rows"):
        ts._halo_exchange_rows(shards, 8)


# ---------------------------------------------------------- full decode

def _rgb_tol(xyb, rgb):
    """Per value of linear RGB: TOL on the XYB it is computed from,
    carried through xyb_to_rgb's cubes and matrix, plus TOL on the RGB."""
    k = tpl._consts()
    x, y, b = xyb[:, 0], xyb[:, 1], xyb[:, 2]
    ex, ey, eb = (TOL["atol"] + TOL["rtol"] * np.abs(c) for c in (x, y, b))
    cb = float(k["cbrt_bias"])
    dmix = np.stack([3 * (y + x + cb) ** 2 * (ex + ey),
                     3 * (y - x + cb) ** 2 * (ex + ey),
                     3 * (b + cb) ** 2 * eb], axis=1)
    carried = np.einsum("ij,bjhw->bihw", np.abs(k["opsin_inv"]), dmix)
    return carried + TOL["atol"] + TOL["rtol"] * np.abs(rgb)


def _jax_full_xyb(qimg, qf, dc, ytox, ytob, dm, ispx, sad, epf_iters):
    """tests/test_sharded_full.py's unsharded chain before xyb_to_rgb."""
    gabk = np.stack([gaborish_kernel(*js.GAB_DEFAULT[c])
                     for c in range(3)]).astype(np.float32)
    outs = []
    for b in range(qimg.shape[0]):
        x = jpl.gaborish_jax(jpl.decode_xyb_image(
            jnp.asarray(qimg[b]), jnp.asarray(qf[b]), jnp.asarray(dc[b]),
            jnp.asarray(ytox[b]), jnp.asarray(ytob[b]), jnp.asarray(dm),
            inv_global_scale=jnp.float32(1024.0), x_dm_mult=1.0,
            b_dm_mult=1.0), gabk)
        if epf_iters:
            x = jpl.epf_jax(x, jnp.asarray(ispx[b]), jnp.asarray(sad[b]),
                            (40.0, 5.0, 3.5), epf_iters)
        outs.append(np.asarray(x))
    return np.stack(outs)


@pytest.mark.parametrize("epf_iters,batch,shape", [
    (0, 2, {}), (2, 2, {}), (3, 2, {}),
    (2, 1, dict(B=1, H=256, W=64, seed=3))])
def test_sharded_decode_full_matches_the_jax_builder(epf_iters, batch,
                                                     shape):
    """tests/test_sharded_full.py's inputs and meshes: (batch 2, rows 4)
    and the batch-1 mesh (all 8 on rows); the port sharded equals the port
    unsharded (a 1-entry mesh) exactly."""
    args = _inputs(**shape)
    ref = np.asarray(js.build_sharded_decode_full(
        _jmesh(8, batch), epf_iters=epf_iters)(*args))
    before = launch_counts()
    got = ts.build_sharded_decode_full(
        ts.Mesh.of("cpu", 8, batch=batch), epf_iters=epf_iters)(*args)
    assert launch_counts() == before  # CPU tensors run the twins
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    xyb = _jax_full_xyb(*args, epf_iters)
    err = np.abs(got - ref)
    assert (err <= _rgb_tol(xyb, ref)).all(), err.max()
    one = ts.build_sharded_decode_full(ts.Mesh.of("cpu", 1),
                                       epf_iters=epf_iters)(*args)
    np.testing.assert_array_equal(got, one.numpy())


def test_sharded_decode_full_refuses_what_shard_map_refuses():
    qimg, qf, dc, ytox, ytob, dm, ispx, sad = _inputs()
    run = ts.build_sharded_decode_full(ts.Mesh.of("cpu", 8, batch=2))
    with pytest.raises(ValueError, match="batch"):
        run(qimg[:1], qf[:1], dc[:1], ytox[:1], ytob[:1], dm, ispx[:1],
            sad[:1])
    bad = ispx.copy()
    bad[0, 3, 5] += 1.0
    with pytest.raises(ValueError, match="constant on each 8x8 block"):
        run(qimg, qf, dc, ytox, ytob, dm, bad, sad)
    bad = sad.copy()
    bad[1, 0, 0] = 2.0
    with pytest.raises(ValueError, match="differs between images"):
        run(qimg, qf, dc, ytox, ytob, dm, ispx, bad)
    run = ts.build_sharded_decode_full(ts.Mesh.of("cpu", 3))
    with pytest.raises(ValueError, match="image rows"):
        run(qimg, qf, dc, ytox, ytob, dm, ispx, sad)


# ------------------------------------------------- block-layout decode

def _block_inputs(batch, nby, nbx, maps, seed):
    """Block-layout coefficients at a photo's XYB magnitudes under the
    builder's global scale 1024 (sparse AC in [-3, 3], qf 64-127, the
    DCT8 table) and CfL maps: "zero" per-block-row maps (batch, nby, 1)
    as the JAX tests and dry run give them, "rows" the same shape
    nonzero, "tiles" nonzero per 64-px tile (batch, nby/8, 1)."""
    rng = np.random.default_rng(seed)
    q = (rng.integers(-3, 4, (batch, 3, nby, nbx, 8, 8))
         * (rng.random((batch, 3, nby, nbx, 8, 8)) < 0.3)).astype(np.int32)
    qf = rng.integers(64, 128, (batch, nby, nbx)).astype(np.int32)
    dc = rng.normal(0, 0.2, (batch, 3, nby, nbx)).astype(np.float32)
    rows = {"zero": nby, "rows": nby, "tiles": nby // 8}[maps]
    ytox = rng.integers(-20, 20, (batch, rows, 1)).astype(np.int32)
    ytob = rng.integers(-20, 20, (batch, rows, 1)).astype(np.int32)
    if maps == "zero":
        ytox[:] = ytob[:] = 0
    dm = library_tables()[0][0].astype(np.float32)
    return q, qf, dc, ytox, ytob, dm


def _unsharded_block_decode(q, qf, dc, ytox, ytob, dm, apply_gab):
    """The JAX reference of tests/test_tpu_pipeline.py: decode_pixels of
    each image, then (apply_gab) the Gaborish of the whole image, its
    rows edge-padded."""
    out = []
    for b in range(q.shape[0]):
        rgb = jpl.decode_pixels(
            *(jnp.asarray(a[b]) for a in (q, qf, dc, ytox, ytob)),
            jnp.asarray(dm), inv_global_scale=jnp.float32(1024.0),
            x_dm_mult=1.0, b_dm_mult=1.0)
        if apply_gab:
            rgb = js._gaborish_local(jnp.pad(
                rgb, ((0, 0), (1, 1), (0, 0)), mode="edge"), js.GAB_DEFAULT)
        out.append(np.asarray(rgb))
    return np.stack(out)


@pytest.mark.parametrize("maps", ["zero", "rows"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("apply_gab", [False, True], ids=["nogab", "gab"])
def test_sharded_block_decode_matches_the_jax_builder(apply_gab, batch,
                                                      maps):
    """On 8 entries (rows 8 or 4), 16 x 8 blocks an image: the port equals
    the JAX builder, with the JAX builder's fault: each row shard
    expands its slice of the per-block-row CfL maps from its own tile 0,
    so with nonzero maps both differ from the unsharded decode (by
    hundreds of times the bound), and with zero maps both equal it."""
    args = _block_inputs(batch, 16, 8, maps, 60 + batch)
    ref = np.asarray(js.build_sharded_decode(
        _jmesh(8, batch), apply_gab=apply_gab)(*args))
    before = launch_counts()
    got = ts.build_sharded_decode(ts.Mesh.of("cpu", 8, batch=batch),
                                  apply_gab=apply_gab)(*args)
    assert launch_counts() == before  # CPU tensors run the twins
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-3)
    whole = _unsharded_block_decode(*args, apply_gab)
    err = np.abs(got.numpy() - whole).max()
    if maps == "zero":
        np.testing.assert_allclose(got.numpy(), whole, rtol=1e-5, atol=1e-3)
    else:
        assert err > 100 * (1e-3 + 1e-5 * np.abs(whole).max()), err


def test_sharded_block_decode_on_whole_colour_tiles_is_unsharded():
    """Per-tile CfL maps with every row shard holding one whole 64-px
    tile (64 block rows over 8 entries): the sharded decode equals the
    unsharded one in both packages."""
    args = _block_inputs(1, 64, 8, "tiles", 70)
    whole = _unsharded_block_decode(*args, True)
    ref = np.asarray(js.build_sharded_decode(_jmesh(8, 1))(*args))
    got = ts.build_sharded_decode(ts.Mesh.of("cpu", 8))(*args).numpy()
    for out in (ref, got):
        np.testing.assert_allclose(out, whole, rtol=1e-5, atol=1e-3)
    one = ts.build_sharded_decode(ts.Mesh.of("cpu", 1))(*args).numpy()
    np.testing.assert_allclose(got, one, rtol=1e-6, atol=1e-6)


def test_sharded_block_decode_refuses_what_shard_map_refuses():
    args = _block_inputs(2, 16, 8, "zero", 80)
    with pytest.raises(ValueError, match="batch"):
        ts.build_sharded_decode(ts.Mesh.of("cpu", 8, batch=2))(
            *(a[:1] for a in args[:5]), args[5])
    with pytest.raises(ValueError, match="block rows"):
        ts.build_sharded_decode(ts.Mesh.of("cpu", 3))(*args)
    q, qf, dc, ytox, ytob, dm = _block_inputs(1, 16, 8, "tiles", 81)
    with pytest.raises(ValueError, match="colour tile rows"):
        ts.build_sharded_decode(ts.Mesh.of("cpu", 4))(q, qf, dc, ytox,
                                                      ytob, dm)


def test_gaborish_local_matches_the_jax_blur():
    x = np.random.default_rng(82).normal(0, 1, (2, 3, 10, 24)).astype(
        np.float32)
    ref = np.asarray(jax.vmap(lambda a: js._gaborish_local(
        a, js.GAB_DEFAULT))(jnp.asarray(x)))
    got = tpl.gaborish(torch.from_numpy(x), ts.GAB_KERNELS)[..., 1:-1, :] \
        .numpy()
    assert got.shape == ref.shape == (2, 3, 8, 24)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert ts.GAB_DEFAULT == js.GAB_DEFAULT


# --------------------------------------------------------------- encode

def _encode_inputs(batch, nby, nbx, seed):
    """__graft_entry__.dryrun_multichip's encode inputs."""
    rng = np.random.default_rng(seed)
    dm, dm_inv = (t.astype(np.float32) for t in library_tables()[0])
    rgb = rng.uniform(0, 1, (batch, 3, nby * 8, nbx * 8)).astype(np.float32)
    qf = rng.integers(32, 96, (batch, nby, nbx)).astype(np.int32)
    inv_dc = np.array([512.0, 64.0, 32.0], dtype=np.float32)
    dm_y = (1.0 / np.where(dm_inv[1] == 0, 1, dm_inv[1])).astype(np.float32)
    return rgb, qf, dm_inv, dm_y, inv_dc


@pytest.mark.parametrize("nby,nbx", [(8, 8), (32, 24)])
def test_sharded_encode_matches_the_jax_builder(nby, nbx):
    args = _encode_inputs(2, nby, nbx, nby)
    jq, jdc = (np.asarray(a) for a in js.build_sharded_encode(
        _jmesh(8, 2))(*args))
    q, qdc = ts.build_sharded_encode(ts.Mesh.of("cpu", 8, batch=2))(*args)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(qdc.numpy(), jdc)
    assert q.dtype == qdc.dtype == torch.int32


def test_encode_coefficients_matches_the_jax_form():
    rgb, qf, dm_inv, dm_y, inv_dc = _encode_inputs(1, 16, 24, 5)
    kw = dict(inv_global_scale=1024.0, x_dm_mult=1.0, b_dm_mult=1.0)
    jq, jdc = jax.jit(jpl.encode_coefficients)(
        rgb[0], qf[0], dm_inv, dm_y, jnp.float32(1024.0), 1.0, 1.0, inv_dc)
    q, qdc = tpl.encode_coefficients(
        torch.from_numpy(rgb[0]), torch.from_numpy(qf[0]), dm_inv, dm_y,
        kw["inv_global_scale"], kw["x_dm_mult"], kw["b_dm_mult"], inv_dc)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(qdc.numpy(), np.asarray(jdc))


# ------------------------------------------------ a real stream, sharded

@pytest.fixture(scope="module")
def stream_512():
    """The JAX dry run's real 512x512 d1/e3 stream (the port's host
    encode writes the JAX package's bytes), host-decoded."""
    stream = tcs.encode_lossy(dryrun.photo(512, np.random.default_rng(7)),
                              distance=1.0, effort=3, device=None)
    return dryrun.StreamRender.of(stream, num_threads=2)


def test_sharded_decode_stream_matches_jax_and_the_single_render(
        stream_512):
    sr = stream_512
    ref = np.asarray(js.build_sharded_decode_stream(
        _jmesh(8, 2), *sr.params)(*sr.args))
    before = launch_counts()
    got = sr.sharded(ts.Mesh.of("cpu", 8, batch=2))(*sr.args)
    assert launch_counts() == before
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape
    dryrun.u8_steps(got.numpy(), ref, "port sharded vs JAX sharded")
    single = sr.single(torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got.numpy().transpose(1, 2, 0), single)


def test_sharded_decode_stream_cuts_at_colour_tiles(stream_512):
    sr = stream_512
    with pytest.raises(ValueError, match="multiple of 64"):
        sr.sharded(ts.Mesh.of("cpu", 16))(*sr.args)  # 32-row shards


# ------------------------------------------------------------ streaming

def test_sharded_streaming_encode_writes_the_sequential_bytes(monkeypatch):
    """The dry run's 320x256 image: the port's bytes with a (2, 4) and a
    (1, 8) mesh equal its sequential bytes; the JAX package's mesh bytes
    equal its own sequential bytes; each side's sharded step gives the
    JAX sharded step's outputs except at boundaries (_assert_step), on
    the JAX inputs and on its own."""
    rng = np.random.default_rng(1)
    img = np.clip(
        128 + 60 * np.sin(np.arange(320)[:, None] * 0.05)
        + 50 * np.cos(np.arange(256)[None, :] * 0.03)
        + rng.normal(0, 6, (320, 256)), 0, 255
    ).astype(np.uint8)[:, :, None].repeat(3, axis=2)
    recorded = {"jax": [], "port": []}

    def recorder(make, key, numpy):
        def wrapped(mesh):
            step = make(mesh)

            def run(*args):
                out = step(*args)
                recorded[key].append((args, [np.asarray(o) for o in out]
                                      if numpy else out, step))
                return out
            return run
        return wrapped

    monkeypatch.setattr(js, "make_sharded_chunk_step",
                        recorder(js.make_sharded_chunk_step, "jax", True))
    monkeypatch.setattr(ts, "make_sharded_chunk_step",
                        recorder(ts.make_sharded_chunk_step, "port", False))
    seq = tcs.encode_lossy_streaming(img, distance=1.0, device="cpu")
    for batch in (2, 1):
        assert tcs.encode_lossy_streaming(
            img, distance=1.0, mesh=ts.Mesh.of("cpu", 8, batch=batch),
            device="cpu") == seq
    jseq = jcs.encode_lossy_streaming(img, distance=1.0)
    assert jcs.encode_lossy_streaming(img, distance=1.0,
                                      mesh=_jmesh(8, 2)) == jseq
    assert len(recorded["jax"]) == 1 and len(recorded["port"]) == 2
    (jargs, jout, _), (args, out, step) = recorded["jax"][0], \
        recorded["port"][0]
    jargs = [np.asarray(a) for a in jargs]
    xyb, dm_inv, dm, igs, _, xdm, bdm, _ = jargs
    for got in (step(*jargs), out):
        _assert_step([torch.from_numpy(o) for o in got], jout, xyb,
                     (igs, xdm, bdm), dm_inv, dm)
    np.testing.assert_allclose(args[0], xyb, **ENC_TOL)
    o, _ = tcs.decode(seq, device=None)
    assert np.abs(o.astype(int) - img.astype(int)).mean() < 8.0


def test_sharded_chunk_step_equals_the_single_device_step():
    rng = np.random.default_rng(4)
    xyb = rng.normal(0, 0.1, (3, 256, 64)).astype(np.float32)
    dm_inv, dm = (t.astype(np.float32) for t in library_tables()[0][::-1])
    qf = rng.integers(8, 40, (32, 8)).astype(np.int32)
    args = (xyb, dm_inv, dm, 8.716, 19.0, 1.0, 1.0, qf)
    from libjxl_tpu_torch.vardct import streaming as tst

    ref = tst.step(*args, torch.device("cpu"))
    got = ts.make_sharded_chunk_step(ts.Mesh.of("cpu", 4))(*args)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="multiple of 64"):
        ts.make_sharded_chunk_step(ts.Mesh.of("cpu", 8))(*args)


# ------------------------------------------- the data-parallel serving decode

@pytest.fixture(scope="module")
def serving_streams():
    rng = np.random.default_rng(1)
    out = []
    for i in range(4):
        im = np.clip(
            120 + 50 * np.sin(np.arange(128)[:, None] * (0.03 + 0.002 * i))
            + rng.normal(0, 8, (128, 128)), 0, 255
        ).astype(np.uint8)[:, :, None].repeat(3, axis=2)
        out.append(tcs.encode_lossy(im, distance=1.0, effort=3, device=None))
    return out


def test_decode_batch_sharded_matches_decode_batch_and_jax(serving_streams):
    got = ttc.decode_batch_sharded(serving_streams,
                                   mesh=ts.Mesh.of("cpu", 4))
    same = ttc.decode_batch(serving_streams, device="cpu")
    jmesh = JMesh(np.array(jax.devices()[:4]), ("batch",))
    ref = jtc.decode_tpu_batch_sharded(serving_streams, mesh=jmesh)
    assert len(got) == len(same) == len(ref) == 4
    for g, s, r in zip(got, same, ref):
        assert g.dtype == np.uint8 and g.shape == (128, 128, 3)
        np.testing.assert_array_equal(g, s)
        assert np.abs(g.astype(int) - np.asarray(r).astype(int)).max() <= 1
    # a (2, 2) mesh splits the batch over all four entries too
    got2 = ttc.decode_batch_sharded(serving_streams,
                                    mesh=ts.Mesh.of("cpu", 4, batch=2))
    for g, s in zip(got2, same):
        np.testing.assert_array_equal(g, s)


def test_decode_batch_sharded_needs_a_batch_that_divides(serving_streams):
    with pytest.raises(JXLError, match="divide across 4 devices"):
        ttc.decode_batch_sharded(serving_streams[:3],
                                 mesh=ts.Mesh.of("cpu", 4))


# -------------------------------------------------------------- dry run

@pytest.mark.parametrize("n,batch", [(4, 2), (8, 2), (3, 1)])
def test_dryrun_codec_step_decodes_the_encoded_blocks(n, batch):
    """The JAX dry run's encode and block-layout decode steps on an
    n-entry mesh; the port's builder held to the JAX builder on the same
    coefficients (their DC is the quantized DC as the dry run passes it,
    so XYB runs to the hundreds: the RGB is held to TOL on the XYB,
    carried, without the blur)."""
    mesh = ts.Mesh.of("cpu", n, batch=batch)
    rec = dryrun.dryrun_codec_step(mesh, np.random.default_rng(1))
    rows = n // batch
    assert rec["block_decode"]["shape"] == [batch, 3, rows * 16, 64]
    assert rec["block_decode"]["max_abs_err"] <= 1e-3  # the same route
    rgb = np.random.default_rng(1).uniform(
        0, 1, (batch, 3, rows * 16, 64)).astype(np.float32)
    dm, dm_inv = library_tables()[0]
    enc = ts.build_sharded_encode(mesh)(
        rgb, np.full((batch, rows * 2, 8), 64, np.int32), dm_inv,
        (1.0 / np.where(dm_inv[1] == 0, 1, dm_inv[1])).astype(np.float32),
        np.array([512.0, 64.0, 32.0], np.float32))
    zeros = np.zeros((batch, rows * 2, 1), np.int32)
    args = (enc[0].numpy(), np.full((batch, rows * 2, 8), 64, np.int32),
            enc[1].numpy().astype(np.float32), zeros, zeros, dm)
    ref = np.asarray(js.build_sharded_decode(
        _jmesh(n, batch), apply_gab=False)(*args))
    got = ts.build_sharded_decode(mesh, apply_gab=False)(*args).numpy()
    xyb = np.stack([np.asarray(jpl.decode_xyb(
        *(jnp.asarray(a[b]) for a in args[:5]), jnp.asarray(dm),
        jnp.float32(1024.0), 1.0, 1.0)) for b in range(batch)])
    err = np.abs(got - ref)
    assert (err <= _rgb_tol(xyb, ref)).all(), err.max()


def test_dryrun_multichip_on_eight_cpu_entries(capsys):
    rec = dryrun.dryrun_multichip(8, device="cpu", big_mp=0.25)
    step = rec["codec_step"]
    assert step["encode_shapes"] == [[2, 3, 8, 8, 8, 8], [2, 3, 8, 8]]
    assert step["block_decode"]["shape"] == [2, 3, 64, 64]
    assert rec["big"]["side"] == 512
    assert rec["real"]["steps"] <= 1 and rec["big"]["steps"] <= 1
    assert rec["serving_steps"] <= 1
    assert "over 8 bands of 64 rows" in capsys.readouterr().out
