"""The roofline arithmetic on known shapes, and the reference's count of AC
symbols against the port's own rANS decode of the same streams."""

import pytest
import torch

from jxlbench import work


def test_tail_ops_by_chain():
    # Gaborish 54; pass 1: 4 x (21 + 5) + 4; pass 2: 4 x (21 + 1) + 4;
    # colour 40
    assert work.tail_ops_per_pixel(2, True) == 54 + 108 + 92 + 40
    assert work.tail_ops_per_pixel(0, False) == 40
    # pass 0: 12 x (21 + 5) + 4
    assert work.tail_ops_per_pixel(3, True) == 54 + 316 + 108 + 92 + 40


def test_render_work_2048():
    nbytes, ops = work.render_work(2048, 2048, 2, True)
    px, blocks, tiles = 2048 * 2048, 256 * 256, 32 * 32
    assert nbytes == 6 * px + 4 * blocks + 12 * blocks + 8 * tiles \
        + 4 * blocks + 3 * px
    assert ops == 38 * 3 * px + 294 * px
    # one 16-frame batch: bound by operations, ~0.41 ms
    b = 16 * work.bound_s(nbytes, ops)
    assert ops / work.FP32_OPS_S > nbytes / work.HBM_BYTES_S
    assert b == pytest.approx(16 * ops / 67e12)
    assert 0.40e-3 < b < 0.42e-3


def test_render_work_pads_to_blocks():
    assert work.render_work(765, 1021, 0, False) \
        == work.render_work(768, 1024, 0, False)


def test_ans_work():
    nbytes, ops = work.ans_work(1000, 500)
    assert (nbytes, ops) == (4500, 100_000)
    assert work.bound_s(nbytes, ops) == pytest.approx(100_000 / 67e12)


def test_tokens_match_the_ports_rans_decode(tmp_path):
    """The maker's ac_tokens (from the reference's coefficients) counts the
    symbols that ans_decode's plain twin steps through, stream by
    stream."""
    from libjxl_tpu_torch.api import tpu_codec
    from libjxl_tpu_torch.ops import ans_kernel

    from jxlbench import inputs

    cfg = {"name": "t", "maker": "vardct_photo", "height": 512,
           "width": 512, "distance": 8.0, "effort": 3, "streams": 2}
    inp, how = inputs.load_or_make(tmp_path, cfg, 5)
    assert how == "made"
    _, _, lp = tpu_codec.prepare_batch_entropy(inp.streams)
    _, ok, steps = ans_kernel.ans_decode_plain(lp.to("cpu"))
    assert bool(ok.all())
    img = torch.from_numpy(lp.lane_img)
    per_image = [int(steps[img == i].sum()) for i in range(2)]
    assert per_image == [f["tokens"] for f in inp.facts]
    again, how = inputs.load_or_make(tmp_path, cfg, 5)
    assert how == "cached" and again.streams == inp.streams
