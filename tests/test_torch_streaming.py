"""libjxl_tpu_torch's streaming VarDCT encode (vardct/streaming.py,
codestream.encode_lossy_streaming) against the JAX package's on the CPU:
tests/test_streaming.py's cases with the port's DC-group step as torch ops
on the CPU (device="cpu"), its bytes equal to the JAX package's.

The multi-DC-group byte test runs at 2176x520 (two DC groups). At the
JAX package's own size, 2176x2304 (four DC groups, marked slow there), the
bytes differ: 5 of its ~15 M quantized coefficients flip by one, each
with the JAX float within 1e-5 of its dead-zone or rounding boundary (the
two sides' cube roots differ by an ulp in ~0.07% of pixels, and the
inverse Gaborish spreads each over 25), which
test_streaming_full_size_steps_differ_only_at_boundaries holds.
"""

import numpy as np
import pytest
from test_torch_encode import _assert_step

from libjxl_tpu.api import codestream as jcs
from libjxl_tpu.ops.xyb import srgb_to_linear
from libjxl_tpu.vardct import streaming as jst
from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.base.device import launch_counts
from libjxl_tpu_torch.vardct import streaming as tst


def smooth(h, w, seed=0):
    """tests/test_streaming.py's generator."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3))
    for i in range(3):
        img[:, :, i] = 128 + 80 * np.sin(xx / 17 + i) * np.cos(yy / 23 - i)
    img += rng.normal(0, 3, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def test_streaming_single_dc_group_writes_the_jax_bytes():
    img = smooth(300, 260)
    before = launch_counts()
    d = tcs.encode_lossy_streaming(img, distance=1.0, device="cpu")
    assert launch_counts() == before  # the step has no hand kernel
    assert d == jcs.encode_lossy_streaming(img, distance=1.0)
    o, _ = tcs.decode(d, device=None)
    assert np.abs(o.astype(int) - img.astype(int)).mean() < 6.0


def test_streaming_multi_dc_group_and_hosts_write_the_jax_bytes():
    """Two DC groups, each with its own histogram set; the thread-per-host
    path is byte-identical to the sequential one and to the JAX
    package's."""
    img = smooth(2176, 520, seed=2)
    d = tcs.encode_lossy_streaming(img, distance=1.5, device="cpu")
    d2 = tcs.encode_lossy_streaming(img, distance=1.5, hosts=2,
                                    device="cpu")
    assert d2 == d
    assert d == jcs.encode_lossy_streaming(img, distance=1.5, hosts=2)
    o, _ = tcs.decode(d, device=None)
    assert np.abs(o.astype(int) - img.astype(int)).mean() < 8.0


def test_streaming_full_size_steps_differ_only_at_boundaries(monkeypatch):
    """tests/test_streaming.py's multi-DC-group image, 2176x2304 at d1.5:
    each DC group's step, on the JAX package's step inputs and on the
    port's own (its XYB), gives the JAX step's outputs, except quantized
    values whose JAX float lies at its boundary (_assert_step)."""
    import torch

    img = smooth(2176, 2304, seed=2)
    prep, step = jst._jitted_chunk_step()
    steps = []

    def recorded(*args):
        out = step(*args)
        steps.append(([np.asarray(a) for a in args],
                      [np.asarray(o) for o in out]))
        return out

    monkeypatch.setattr(jst, "_jitted_chunk_step", lambda: (prep, recorded))
    ours = []

    def own(*args):
        out = tst_step(*args)
        ours.append((args, out))
        return out

    tst_step = tst.step
    monkeypatch.setattr(tst, "step", own)
    jcs.encode_lossy_streaming(img, distance=1.5)
    tcs.encode_lossy_streaming(img, distance=1.5, device="cpu")
    assert len(steps) == len(ours) == 4
    cpu = torch.device("cpu")
    for (jargs, jout), (args, _) in zip(steps, ours):
        xyb, dm_inv, dm, igs, bq, xdm, bdm, qf_in = jargs
        np.testing.assert_array_equal(args[7], qf_in)
        for out in (tst_step(*jargs, cpu), tst_step(*args)):
            _assert_step([torch.from_numpy(o) for o in out], jout, xyb,
                         (igs, xdm, bdm), dm_inv, dm)


def test_streaming_chunk_provider_writes_the_jax_bytes():
    """Chunk-callback input: the provider is asked only for bounded
    regions (the bounded-memory contract)."""
    img = smooth(280, 320, seed=5)
    rgb = np.moveaxis(srgb_to_linear(img.astype(np.float64) / 255.0), -1, 0)
    max_area = [0]

    def get_chunk(px0, py0, w, h):
        max_area[0] = max(max_area[0], w * h)
        out = np.zeros((3, h, w))
        x1 = min(px0 + w, rgb.shape[2])
        y1 = min(py0 + h, rgb.shape[1])
        out[:, :y1 - py0, :x1 - px0] = rgb[:, py0:y1, px0:x1]
        return out

    d = tcs.encode_lossy_streaming(get_chunk, width=320, height=280,
                                   distance=1.0, device="cpu")
    assert max_area[0] <= (2048 + 16) ** 2
    assert d == jcs.encode_lossy_streaming(get_chunk, width=320, height=280,
                                           distance=1.0)
    o, _ = tcs.decode(d, device=None)
    assert np.abs(o.astype(int) - img.astype(int)).mean() < 6.5


def test_streaming_tracks_oneshot_rate_and_quality():
    """The streaming encoder's up-front global scale stays near the
    one-shot encoder's field-median choice (tests/test_streaming.py's
    bounds), both encodes on the CPU's torch ops and byte-equal to the
    JAX package's."""
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:320, 0:320]
    img = np.clip(128 + 60 * np.sin(xx * 0.02) + 40 * np.cos(yy * 0.03)
                  + rng.normal(0, 8, (320, 320)), 0, 255
                  ).astype(np.uint8)[:, :, None].repeat(3, axis=2)
    one = tcs.encode_lossy(img, distance=1.0, effort=3, device="cpu")
    stream = tcs.encode_lossy_streaming(img, distance=1.0, device="cpu")
    assert one == jcs.encode_lossy(img, distance=1.0, effort=3,
                                   device=True)
    assert stream == jcs.encode_lossy_streaming(img, distance=1.0)
    d_one, _ = tcs.decode(one, device=None)
    d_str, _ = tcs.decode(stream, device=None)
    e_one = np.abs(d_one[:, :, :3].astype(float) - img).mean()
    e_str = np.abs(d_str[:, :, :3].astype(float) - img).mean()
    assert len(stream) < len(one) * 2.0, (len(stream), len(one))
    assert e_str < e_one * 1.8 + 0.5, (e_str, e_one)


def test_streaming_has_no_host_route():
    with pytest.raises(ValueError, match="device=None"):
        tcs.encode_lossy_streaming(smooth(64, 64), device=None)
