"""A run with the timed path broken underneath comes out as not correct:
the harness's look for a card skipped, the port run on the CPU at a small
size, each fault planted where the images are produced (the batch paths'
tpu_codec._crop and _render, the single image's render_image)."""

import numpy as np
import pytest

from libjxl_tpu_torch.api import tpu_codec

from .conftest import add_cell, run_cpu, tiny

# the two host-entropy mixes whose cells PERF.md keeps for later: their
# entries and traffic files run here all the same
LATER = ["photo2k_d1_e3.pipelined16", "photo2k_d1_e3.sharded16_4cards"]


def stale(produce):
    """Each call hands back what the call before it produced."""
    last = {}

    def f(*a, **k):
        out = produce(*a, **k)
        prev, last["out"] = last.get("out", out), out
        return prev
    return f


def half(images):
    if isinstance(images, np.ndarray):  # one frame: its lower half
        out = images.copy()
        out[out.shape[0] // 2:] = 0
        return out
    n = len(images)
    return images[:n - n // 2] + images[:n // 2]


def altered(images):
    first = images if isinstance(images, np.ndarray) else images[0]
    first = first.copy()
    first[:8, :8] += 16
    if isinstance(images, np.ndarray):
        return first
    return [first] + list(images[1:])


def after(produce, fault):
    return lambda *a, **k: fault(produce(*a, **k))


FAULTS = {"stale": stale, "half": lambda p: after(p, half),
          "altered": lambda p: after(p, altered)}


@pytest.fixture(scope="module")
def batch_root(tmp_path_factory):
    # 4 a batch, so that each of a 2-entry mesh's shards holds 2 images
    # and the pipelined mix's two batches a call hold other streams
    root, bench = tiny(tmp_path_factory.mktemp("b"), size=256, streams=8,
                       per_call=4)
    for cell in LATER:
        config, traffic = cell.split(".")
        add_cell(root, config, traffic, "batch_mps")
    return root, bench


@pytest.mark.parametrize("cell", LATER)
def test_batch_cell_sound(batch_root, cell):
    out, lines = run_cpu(*batch_root, cell, chips=2)
    assert out["correct"] and out["failed"] == 0, lines


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", LATER)
def test_batch_cell_fault(batch_root, cell, fault, monkeypatch):
    monkeypatch.setattr(tpu_codec, "_crop", FAULTS[fault](tpu_codec._crop))
    out, lines = run_cpu(*batch_root, cell, chips=2)
    assert out["correct"] is False, (fault, lines)


def test_sharded_exchange_left_out(batch_root, monkeypatch):
    """Only the first card's share comes back; the other cards' images
    are never gathered (zeros in their place)."""
    render = tpu_codec._render
    seen = {"n": 0}

    def first_only(config, args, device):
        images = render(config, args, device)
        seen["n"] += 1
        if seen["n"] % 2 == 0:  # the second entry of the 2-entry mesh
            return [np.zeros_like(im) for im in images]
        return images

    monkeypatch.setattr(tpu_codec, "_render", first_only)
    out, lines = run_cpu(*batch_root, "photo2k_d1_e3.sharded16_4cards",
                         chips=2)
    assert out["correct"] is False, lines


@pytest.fixture(scope="module")
def single_root(tmp_path_factory):
    return tiny(tmp_path_factory.mktemp("s"), size=256, streams=2)


def test_single_cell_sound(single_root):
    out, lines = run_cpu(*single_root, "photo2k_d1_e5.single")
    assert out["correct"] and out["failed"] == 0, lines


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_single_cell_fault(single_root, fault, monkeypatch):
    monkeypatch.setattr(tpu_codec, "render_image",
                        FAULTS[fault](tpu_codec.render_image))
    out, lines = run_cpu(*single_root, "photo2k_d1_e5.single")
    assert out["correct"] is False, (fault, lines)


@pytest.fixture(scope="module")
def entropy_root(tmp_path_factory):
    return tiny(tmp_path_factory.mktemp("e"), size=512, streams=4,
                per_call=2, warmup=1, distance=8.0)


@pytest.mark.parametrize("fault", [None, *sorted(FAULTS)])
def test_device_entropy_cell(entropy_root, fault, monkeypatch):
    """decode_batch_entropy on the CPU (ans_decode's plain twin): sound, and
    each fault planted in the list of images it produces."""
    if fault is not None:
        monkeypatch.setattr(tpu_codec, "_crop",
                            FAULTS[fault](tpu_codec._crop))
    out, lines = run_cpu(*entropy_root, "photo2k_d1_e3.device_entropy16",
                         seconds=0.01)
    assert out["failed"] == 0, lines
    assert out["correct"] is (fault is None), (fault, lines)
