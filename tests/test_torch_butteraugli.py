"""libjxl_tpu_torch/metrics/butteraugli_torch.py on the CPU against the
JAX package's device comparator (libjxl_tpu/metrics/butteraugli_jax.py,
XLA on the CPU) and the port's host model (metrics/butteraugli.py).

Tolerances: the diffmap within 1e-4 of the JAX one, relative with
tests/test_butteraugli_jax.py's 1e-3 floor (the X channel of the opsin
dynamics is a difference of two near-equal terms, so an ulp of the
logarithm there moves the map by up to ~1e-4); within that test's 2e-3
of the host model; the stages downstream of the opsin dynamics, fed the
same input, within 1e-6 relative of the JAX stages; the score within that
test's 0.01 + 1% of the host score.
"""

import numpy as np
import pytest
import torch

from libjxl_tpu.metrics import butteraugli_jax as jb
from libjxl_tpu_torch.metrics import butteraugli as hb
from libjxl_tpu_torch.metrics import butteraugli_torch as tb
from tests.test_butteraugli_jax import _pair

PAIRS = {"96x128": dict(h=96, w=128), "67x45": dict(h=67, w=45)}
FLOOR = 1e-3  # tests/test_butteraugli_jax.py's relative-error floor
STAGE_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, ref):
    return float((np.abs(got - ref) / (np.abs(ref) + FLOOR)).max())


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_diffmap_matches_the_jax_package(pair):
    a, b = _pair(**PAIRS[pair])
    ref = np.asarray(jb.butteraugli_diffmap_jax(a, b))
    got = tb.butteraugli_diffmap_torch(_t(a), _t(b))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= 1e-4


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_diffmap_matches_the_host_model(pair):
    a, b = _pair(**PAIRS[pair])
    got = tb.butteraugli_diffmap_torch(_t(a), _t(b)).numpy()
    assert _rel(got, hb.butteraugli_diffmap(a, b)) < 2e-3


@pytest.mark.parametrize("noise", [0.003, 0.03])
def test_score_matches_the_host_model(noise):
    a, b = _pair(noise=noise, seed=3)
    s_host = hb.butteraugli_score(a, b)
    s_dev = tb.butteraugli_score_torch(_t(a), _t(b))
    assert abs(s_host - s_dev) < 0.01 + 0.01 * s_host, (s_host, s_dev)


def test_identical_images_score_zero():
    a, _ = _pair()
    assert tb.butteraugli_score_torch(_t(a), _t(a)) < 1e-4
    assert tb.butteraugli_score_torch(_t(a[:, :7]), _t(a[:, :7] * 0.5)) \
        == 0.0


def _xyb(pair):
    """The JAX opsin dynamics of the pair's first image: the stages' input."""
    a, _ = _pair(**PAIRS[pair])
    return np.asarray(jb.opsin_dynamics_image(np.float32(a)))


def _flat(parts):
    return [np.asarray(p) for p in parts]


def _stage_separate_frequencies(xyb):
    j = jb.separate_frequencies(xyb)
    t = tb.separate_frequencies(_t(xyb))
    return [np.asarray(j[0]), np.asarray(j[1])] + _flat(j[2]) + _flat(j[3]), \
        [t[0].numpy(), t[1].numpy()] + [p.numpy() for p in t[2] + t[3]]


def _stage_malta(xyb):
    v0 = np.asarray(jb.separate_frequencies(xyb)[3][1])
    v1 = np.float32(v0 * 0.9 + 0.01)
    out_j, out_t = [], []
    for lf in (False, True):
        out_j.append(np.asarray(jb._malta_diff_map(v0, v1, 1.5, 0.7, 71.78,
                                                   lf)))
        out_t.append(tb._malta_diff_map(_t(v0), _t(v1), 1.5, 0.7, 71.78,
                                        lf).numpy())
    return out_j, out_t


def _stage_fuzzy_erosion(xyb):
    src = np.abs(xyb[0]) + 0.1 * np.abs(xyb[1])
    return [np.asarray(jb._fuzzy_erosion(src))], \
        [tb._fuzzy_erosion(_t(src)).numpy()]


def _stage_blur(xyb):
    return [np.asarray(jb._blur(xyb[1], s)) for s in (1.2, 7.15593339443)], \
        [tb._blur(_t(xyb[1]), s).numpy() for s in (1.2, 7.15593339443)]


def _stage_subsample2x(xyb):
    return [np.asarray(jb._subsample2x(xyb))], \
        [tb._subsample2x(_t(xyb)).numpy()]


STAGES = {"separate_frequencies": _stage_separate_frequencies,
          "malta_diff_map": _stage_malta,
          "fuzzy_erosion": _stage_fuzzy_erosion,
          "blur": _stage_blur,
          "subsample2x": _stage_subsample2x}


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_matches_the_jax_package(stage, pair):
    ref, got = STAGES[stage](_xyb(pair))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, **STAGE_TOL)


def test_blur_matrices_are_cached_per_device():
    dev = torch.device("cpu")
    m = tb._blur_matrix(40, 2.7, dev)
    assert m is tb._blur_matrix(40, 2.7, dev)
    np.testing.assert_array_equal(m.numpy(), jb._blur_matrix(40, 2.7))
