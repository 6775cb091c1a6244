"""libjxl_tpu_torch/api/tpu_codec.py: the batched VarDCT serving decode
on real streams, against the JAX package's batched path on the CPU and
the host decode, plus a run with JAX blocked from import."""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

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


def test_batch_from_numpy_renders_the_jax_state(corpus):
    """The JAX path's staged arguments, carried across, render what the
    port's own staging renders."""
    streams, _ = corpus[(320, 264)]
    config, _ = tpu_codec.prepare_batch(streams)
    _, jargs = prepare_tpu_batch(streams)
    renderer, inputs = tpu_codec.batch_from_numpy(jargs, config, "cpu")
    u8 = renderer(*inputs).numpy()
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
