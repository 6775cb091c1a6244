"""libjxl_tpu_torch/api/tpu_codec.py: the batched VarDCT serving decode
on real streams, against the JAX package's batched path on the CPU and
the host decode, plus a run with JAX blocked from import."""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from libjxl_tpu.api import codestream
from libjxl_tpu.api.tpu_codec import decode_tpu_batch, prepare_tpu_batch
from libjxl_tpu_torch.api import tpu_codec
from libjxl_tpu_torch.base.status import JXLError

# (height, width): one group with the qblocks assembly, several groups
# with the bulk qimg, and a size that is not a multiple of 8 (true-size
# mirror and crop)
GEOMETRIES = [(256, 192), (320, 264), (61, 45)]


def _encode(n, h, w, seed, **kw):
    rng = np.random.default_rng(seed)
    streams, refs = [], []
    for i in range(n):
        img = np.clip(rng.normal(110 + 15 * i, 35, (h, w, 3)), 0,
                      255).astype(np.uint8)
        s = codestream.encode_lossy(img, distance=1.0, effort=3,
                                    device=False, **kw)
        streams.append(s)
        refs.append(codestream.decode(s, device=False)[0][:, :, :3])
    return streams, refs


@pytest.fixture(scope="module")
def corpus():
    return {g: _encode(2, *g, seed=40 + i) for i, g in enumerate(GEOMETRIES)}


def _max_step(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_prepare_batch_matches_jax_exactly(corpus, geometry):
    streams, _ = corpus[geometry]
    config, args = tpu_codec.prepare_batch(streams)
    _, jargs = prepare_tpu_batch(streams)
    assert len(args) == len(jargs) == 10
    for a, j in zip(args, jargs):
        assert a.dtype == j.dtype
        np.testing.assert_array_equal(a, j)
    h, w = args[0].shape[-2:]
    assert (config.height, config.width) == (h, w)
    ts = None if geometry == (h, w) else geometry
    assert config.true_size == ts
    assert (config.epf_iters, config.gab) == (2, True)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_decode_batch_within_one_step_of_jax_and_host(corpus, geometry):
    streams, refs = corpus[geometry]
    outs = tpu_codec.decode_batch(streams, "cpu")
    jax_outs = decode_tpu_batch(streams)
    th, tw = geometry
    for out, jout, ref in zip(outs, jax_outs, refs):
        # the JAX batch leaves the block padding on; the port crops it
        assert out.shape == ref.shape == (th, tw, 3)
        assert out.dtype == np.uint8
        assert _max_step(out, jout[:th, :tw]) <= 1
        assert _max_step(out, ref) <= 1


def test_render_batch_renders_the_jax_state(corpus):
    """The JAX path's staged arguments, carried across, render what the
    port's own staging renders."""
    from libjxl_tpu_torch.ops.staging import to_device

    streams, _ = corpus[(320, 264)]
    config, _ = tpu_codec.prepare_batch(streams)
    _, jargs = prepare_tpu_batch(streams)
    with torch.inference_mode():
        u8 = tpu_codec.render_batch(*to_device(tuple(jargs), "cpu"),
                                    config=config).numpy()
    assert u8.shape == (2, 320, 264, 3)
    for a, b in zip(u8, tpu_codec.decode_batch(streams, "cpu")):
        assert np.array_equal(a, b)


def test_pipelined_equals_batched(corpus):
    """Uneven tail batch, two geometries across batches."""
    a, ra = corpus[(256, 192)]
    b, rb = corpus[(61, 45)]
    streams = a + a[:1] + b
    piped = tpu_codec.decode_pipelined(streams, "cpu", batch_size=3)
    assert len(piped) == 5
    base = tpu_codec.decode_batch(streams[:3], "cpu") \
        + tpu_codec.decode_batch(streams[3:], "cpu")
    for p, q, ref in zip(piped, base, ra + ra[:1] + rb):
        assert np.array_equal(p, q)
        assert _max_step(p, ref) <= 1
    assert tpu_codec.decode_pipelined([], "cpu") == []


def test_scope_gates_raise_jxlerror(corpus):
    a, _ = corpus[(256, 192)]
    b, _ = corpus[(320, 264)]
    with pytest.raises(JXLError, match="empty"):
        tpu_codec.prepare_batch([])
    with pytest.raises(JXLError, match="mixed geometry"):
        tpu_codec.decode_batch(a + b, "cpu")
    with pytest.raises(JXLError, match="mixed geometry"):
        tpu_codec.decode_pipelined(a + b, "cpu", batch_size=3)
    img = np.full((32, 32, 3), 90, np.uint8)
    lossless = codestream.encode_lossless(img)
    with pytest.raises(JXLError, match="host stages"):
        tpu_codec.decode_batch([lossless], "cpu")
    mixed_filters, _ = _encode(1, 256, 192, seed=50, epf=3)
    with pytest.raises(JXLError, match="mixed filter config"):
        tpu_codec.decode_batch(a[:1] + mixed_filters, "cpu")


def test_epf3_batch_runs_the_pass0_geometry(corpus):
    streams, refs = _encode(2, 64, 72, seed=51, epf=3)
    config, _ = tpu_codec.prepare_batch(streams)
    assert config.epf_iters == 3
    jax_outs = decode_tpu_batch(streams)
    for out, jout, ref in zip(tpu_codec.decode_batch(streams, "cpu"),
                              jax_outs, refs):
        assert _max_step(out, jout) <= 1
        assert _max_step(out, ref) <= 1


def test_public_decode_batch_falls_back(corpus):
    """codestream.decode_batch(..., device="cpu") returns each stream's
    pixels when the list is not one batch (tests/test_decode_batch.py's
    test of the JAX package)."""
    from libjxl_tpu_torch.api import codestream as tcs

    a, ra = corpus[(320, 264)]
    b, rb = corpus[(61, 45)]
    outs = tcs.decode_batch([a[0], b[0]], device="cpu")
    assert _max_step(outs[0], ra[0]) <= 1
    assert _max_step(outs[1], rb[0]) <= 1
    assert tcs.decode_batch([], device="cpu") == []


def test_decode_batch_buckets_mixed_geometry(corpus, monkeypatch):
    """A mixed fleet buckets by geometry: each same-size pair is one
    batched render, the singleton (a one-group e3 stream) and the ICC and
    spline streams, which fall outside the batch scope, decode one by one
    through decode(..., device=...); order is kept."""
    from libjxl_tpu.render.splines import Spline
    from libjxl_tpu_torch.api import codestream as tcs
    from libjxl_tpu_torch.extras import cms

    a, ra = corpus[(256, 192)]
    b, rb = corpus[(320, 264)]
    c, rc = _encode(1, 64, 96, seed=52)
    img = np.clip(np.random.default_rng(53).normal(120, 30, (96, 96, 3)), 0,
                  255).astype(np.uint8)
    icc = cms.make_rgb_profile(((0.64, 0.33), (0.21, 0.71), (0.15, 0.06)),
                               gamma=2.2)
    color = np.zeros((3, 32))
    color[:, 0] = (0.2, 0.5, 0.4)
    sigma = np.zeros(32)
    sigma[0] = 2.0
    gated = [codestream.encode_lossy(img, distance=1.0, effort=3, icc=icc,
                                     device=False),
             codestream.encode_lossy(img, distance=1.0, effort=3,
                                     device=False, splines=[Spline(
                                         np.array([[20.0, 20.0],
                                                   [60.0, 50.0]]),
                                         color, sigma)])]
    gated_refs = [codestream.decode(s, device=False)[0] for s in gated]
    mixed = [a[0], b[0], gated[0], c[0], a[1], gated[1], b[1]]
    refs = [ra[0], rb[0], gated_refs[0], rc[0], ra[1], gated_refs[1], rb[1]]
    batches, singles = [], []
    real_batch, real_decode = tpu_codec.decode_batch, tcs.decode

    def spy_batch(streams, *args, **kw):
        batches.append([mixed.index(s) for s in streams])
        return real_batch(streams, *args, **kw)

    def spy_decode(data, *args, **kw):
        singles.append((mixed.index(data), str(kw.get("device"))))
        return real_decode(data, *args, **kw)

    monkeypatch.setattr(tpu_codec, "decode_batch", spy_batch)
    monkeypatch.setattr(tcs, "decode", spy_decode)
    outs = tcs.decode_batch(mixed, device="cpu")
    # the whole list first, then each bucket of two or more
    assert batches == [list(range(7)), [0, 4], [1, 6], [2, 5]]
    assert sorted(singles) == [(2, "cpu"), (3, "cpu"), (5, "cpu")]
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert o.shape == r.shape, i
        assert _max_step(o, r) <= 1, i


_NO_JAX = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError("jax is blocked")
            return None

    sys.meta_path.insert(0, NoJax())
    import numpy as np
    import libjxl_tpu_torch
    for m in pkgutil.walk_packages(libjxl_tpu_torch.__path__,
                                   "libjxl_tpu_torch."):
        importlib.import_module(m.name)
    from libjxl_tpu.api import codestream
    from libjxl_tpu_torch.api import tpu_codec

    img = np.clip(np.random.default_rng(3).normal(120, 30, (64, 80, 3)),
                  0, 255).astype(np.uint8)
    s = codestream.encode_lossy(img, distance=1.0, effort=3, device=False)
    ref = codestream.decode(s, device=False)[0][:, :, :3]
    out = tpu_codec.decode_pipelined([s, s], "cpu", batch_size=1)
    assert all(np.abs(o.astype(int) - ref.astype(int)).max() <= 1
               for o in out)
    # two AC groups (one group decodes inline, with no raw sections):
    # the rANS twin and the placement run
    yy, xx = np.mgrid[0:256, 0:512]
    smooth = np.clip(128 + 50 * np.sin(xx * 0.013) + 40 * np.cos(yy * 0.009),
                     0, 255).astype(np.uint8)[..., None].repeat(3, 2)
    s2 = codestream.encode_lossy(smooth, distance=4.0, effort=3,
                                 device=False)
    imgs, info = tpu_codec.decode_batch_entropy([s2], "cpu")
    assert info == {"path": "device_entropy"}, info
    assert np.array_equal(imgs[0], tpu_codec.decode_batch([s2], "cpu")[0])
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
    assert not bad, bad
    print("NO_JAX_OK")
""")


def test_port_runs_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", _NO_JAX],
                         cwd=pathlib.Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
