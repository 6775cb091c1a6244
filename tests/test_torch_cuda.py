"""libjxl_tpu_torch/ops/kernels.py and libjxl_tpu_torch/probes on a CUDA
card: each hand-written kernel against its plain twin, with its launch
counter, and the two decode paths against the CPU's. Skipped without a
card. Imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from libjxl_tpu_torch.ops import kernels
from libjxl_tpu_torch.ops import pipeline as tpl
from libjxl_tpu_torch.probes import gather
from libjxl_tpu_torch.render.pipeline import _sad_mul_map, gaborish_kernel

GEOMETRIES = {
    "pass0": (tpl._EPF0_NEIGHBORS, tpl._EPF_PLUS, 0.9),
    "pass1": (tpl._EPF12_NEIGHBORS, tpl._EPF_PLUS, 1.0),
    "pass2": (tpl._EPF12_NEIGHBORS, None, 6.5),
}
CS = (40.0, 5.0, 3.5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _epf_inputs(seed, b, h, w):
    """XYB, per-block inv_sigma (one block below kMinSigma, so the skip
    path runs) and the per-pixel SAD multiplier."""
    rng = np.random.default_rng(seed)
    xyb = rng.normal(0, 0.3, (b, 3, h, w)).astype(np.float32)
    isg = rng.uniform(-3.0, -0.1, (b, -(-h // 8), -(-w // 8))).astype(
        np.float32)
    isg[:, 0, 1] = -5.0
    sad = rng.uniform(0.8, 1.2, (h, w)).astype(np.float32)
    return xyb, isg, sad


def _tail_inputs(seed, b, h, w):
    """In-gamut XYB at a photo's magnitudes with mild noise, per-block
    inv_sigma at real streams' values (one block below kMinSigma, so the
    pass-through runs), the encoder's default Gaborish and SAD map."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = 0.1 * np.sin(xx * 0.3) * np.cos(yy * 0.2)
    xyb = np.stack([0.01 * smooth + rng.normal(0, 0.002, (b, h, w)),
                    0.45 + smooth + rng.normal(0, 0.02, (b, h, w)),
                    0.40 + 0.5 * smooth + rng.normal(0, 0.02, (b, h, w))],
                   axis=1).astype(np.float32)
    isg = rng.uniform(-2.5, -0.3, (b, -(-h // 8), -(-w // 8)))
    isg[:, 0, -1] = -5.0
    gab = np.stack([gaborish_kernel(0.115169525, 0.061248592)] * 3)
    sad = _sad_mul_map(h, w, 2.0 / 3.0)
    return (xyb, isg.astype(np.float32), gab.astype(np.float32),
            sad.astype(np.float32))


def chain_tol(gab, epf_iters):
    """K2's tolerance, rtol 2e-4 / atol 2e-5 a pass (the two EPF forms of
    the reference sum in different orders, tests/test_pallas.py),
    compounded over the chain's filter stages."""
    n = max(1, int(gab) + epf_iters)
    return dict(rtol=2e-4 * n, atol=2e-5 * n)


def _dequant_inputs(seed, b, h, w, qdtype=np.int32):
    """Staged batch arrays at the magnitudes real d1 streams give: sparse
    small AC coefficients, scale = inv_global_scale / qf of a few units."""
    rng = np.random.default_rng(seed)
    nby, nbx = h // 8, w // 8
    nty, ntx = -(-nby // 8), -(-nbx // 8)
    sparse = rng.random((b, 3, h, w)) < 0.1
    return ((rng.integers(-3, 4, (b, 3, h, w)) * sparse).astype(qdtype),
            rng.integers(2, 30, (b, nby, nbx)).astype(np.int32),
            rng.normal(0, 0.2, (b, 3, nby, nbx)).astype(np.float32),
            rng.integers(-10, 10, (b, nty, ntx)).astype(np.int32),
            rng.integers(-45, -30, (b, nty, ntx)).astype(np.int32),
            rng.uniform(3e-4, 0.01, (3, 8, 8)).astype(np.float32),
            rng.uniform(6.0, 10.0, (b,)).astype(np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(128, 200), (16, 264), (8, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("qdtype", [np.int16, np.int32])
def test_dequant_idct8_kernel_matches_plain(cuda, qdtype, size):
    """Widths ragged against the kernel's 32-block CTAs (25, 33, 1
    blocks): the groups past the edge join the shuffles and store
    nothing."""
    args = [_t(a).to(cuda) for a in _dequant_inputs(16, 2, *size, qdtype)]
    n = kernels.DEQUANT_IDCT8_LAUNCHES.count
    got = kernels.dequant_idct8(*args, 0.8, 1.0)
    ref = tpl.decode_xyb_image(*args, 0.8, 1.0)
    torch.cuda.synchronize()
    assert kernels.DEQUANT_IDCT8_LAUNCHES.count == n + 1
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_epf_pass_kernel_matches_plain(cuda, geometry):
    """Each pass geometry alone: render_tail's kernel in its one-pass
    configuration, counted under render_tail."""
    neigh, pattern, scale = GEOMETRIES[geometry]
    xyb, isg, sad = _epf_inputs(17, 2, 70, 50)  # ragged against the tile
    isp = np.repeat(np.repeat(isg, 8, 1), 8, 2)[:, :70, :50]
    n = kernels.RENDER_TAIL_LAUNCHES.count
    got = kernels.epf_pass(_t(xyb).to(cuda), _t(isg).to(cuda),
                           _t(sad).to(cuda), CS, neigh, pattern, scale)
    ref = tpl._epf_pass(_t(xyb).to(cuda), _t(isp).to(cuda),
                        _t(sad).to(cuda), CS, neigh, pattern, scale)
    torch.cuda.synchronize()
    assert kernels.RENDER_TAIL_LAUNCHES.count == n + 1
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(70, 50), (40, 136), (8, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("gab", [False, True], ids=["nogab", "gab"])
@pytest.mark.parametrize("epf_iters", [0, 1, 2, 3])
def test_render_tail_kernel_matches_plain(cuda, epf_iters, gab, size):
    """Every chain, XYB out at K2's compounded tolerance and u8 out within
    one step, at sizes ragged against the 16x64 tile and at 8x8 (smaller
    than a tile, at most the halo away from every edge): one launch
    each."""
    xyb, isg, gabk, sad = (_t(a).to(cuda) for a in _tail_inputs(
        50 + epf_iters, 2, *size))
    args = (xyb, gabk if gab else None, isg, sad, CS, epf_iters, 0.9, 6.5)
    n = kernels.RENDER_TAIL_LAUNCHES.count
    got = kernels.render_tail(*args, out="xyb")
    got_u8 = kernels.render_tail(*args, out="u8srgb")
    ref = tpl.render_tail_plain(*args, out="xyb")
    ref_u8 = tpl.render_tail_plain(*args, out="u8srgb")
    torch.cuda.synchronize()
    assert kernels.RENDER_TAIL_LAUNCHES.count == n + 2
    torch.testing.assert_close(got, ref, **chain_tol(gab, epf_iters))
    assert got_u8.shape == ref_u8.shape and got_u8.dtype == torch.uint8
    assert (got_u8.int() - ref_u8.int()).abs().max().item() <= 1


@pytest.mark.cuda
def test_decode_batch_on_card_matches_cpu(cuda):
    """The slice on real streams: the card's render (both kernels) within
    one u8 step of the CPU's (the plain twins), one dequant_idct8 and one
    render_tail launch per batch."""
    from libjxl_tpu_torch.api import codestream, tpu_codec
    from libjxl_tpu_torch.base.device import launch_counts

    rng = np.random.default_rng(18)
    streams = [codestream.encode_lossy(
        np.clip(rng.normal(120, 30, (100, 132, 3)), 0, 255).astype(np.uint8),
        distance=1.0, effort=3, device=None) for _ in range(2)]
    before = launch_counts()
    got = tpu_codec.decode_batch(streams, cuda)
    after = launch_counts()
    assert {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == {
        "dequant_idct8": 1, "render_tail": 1}
    for g, c in zip(got, tpu_codec.decode_batch(streams, "cpu")):
        assert g.shape == c.shape == (100, 132, 3)
        assert np.abs(g.astype(int) - c.astype(int)).max() <= 1


def _photo(h, w, seed):
    """Smooth content, a textured patch and mild noise: e5 picks dense
    size passes and 8x8 special tiles on it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (120 + 60 * np.sin(xx * 0.03) + 50 * np.cos(yy * 0.02 + 1)
           + 20 * np.sin((xx + yy) * 0.1) + rng.normal(0, 5, (h, w)))
    patch = (slice(h // 3, h // 2), slice(w // 4, w // 2))
    img[patch] += 60 * ((xx[patch] // 4) % 2)
    rgb = np.stack([img, img * 0.9 + 10, img * 1.1 - 12], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _launched(fn, *args, **kw):
    from libjxl_tpu_torch.base.device import launch_counts

    before = launch_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    after = launch_counts()
    return out, {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,path", [((256, 256), "device:u8"),
                                        ((250, 189), "device:xyb")],
                         ids=["aligned", "true-size-crop"])
def test_decode_on_card_matches_cpu(cuda, shape, path):
    """The single-image render of an e5 frame (size passes and special
    tiles): the same path record as on the CPU, u8 within one step of
    the CPU's render (the twins), one dequant_idct8 and one render_tail
    launch."""
    from libjxl_tpu_torch.api import codestream

    data = codestream.encode_lossy(_photo(*shape, 3), distance=1.0,
                                   effort=5, device=None)
    info, cinfo = {}, {}
    (got, _), n = _launched(codestream.decode, data, device=cuda,
                            decode_info=info)
    ref, _ = codestream.decode(data, device="cpu", decode_info=cinfo)
    assert info["path"] == cinfo["path"] == path
    assert n == {"dequant_idct8": 1, "render_tail": 1}
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.cuda
def test_decode_ycbcr_on_card_matches_cpu(cuda):
    """The JPEG transcode of the corpus (4:2:0 YCbCr): one render_tail
    launch, u8 within one step of the CPU's render."""
    import pathlib

    from libjxl_tpu_torch.api import codestream

    data = (pathlib.Path(__file__).resolve().parent / "data" / "conformance"
            / "jpeg_recon.jxl").read_bytes()
    info = {}
    (got, _), n = _launched(codestream.decode, data, device=cuda,
                            decode_info=info)
    ref, _ = codestream.decode(data, device="cpu")
    assert info["path"] == "device:u8-ycbcr"
    assert n == {"render_tail": 1}
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def _filtered_ycbcr420(h, w):
    """A 4:2:0 YCbCr stream of _photo with Gaborish and 2 EPF passes
    (tests/test_decode_path.py's builder, the port's encoder)."""
    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.io.bits import BitWriter
    from libjxl_tpu_torch.io.frame_header import (
        CT_YCBCR, ENC_VARDCT, FLAG_SKIP_ADAPTIVE_DC_SMOOTHING, FT_REGULAR,
        FrameHeader)
    from libjxl_tpu_torch.io.headers import CodecMetadata, SizeHeader
    from libjxl_tpu_torch.vardct.frame import rgb_to_ycbcr
    from libjxl_tpu_torch.vardct.subsampled import encode_vardct_subsampled

    meta = CodecMetadata()
    meta.size = SizeHeader().set(w, h)
    meta.m.all_default = False
    meta.m.xyb_encoded = False
    wr = BitWriter()
    codestream.write_codestream_header(wr, meta)
    fh = FrameHeader(meta)
    fh.all_default = False
    fh.frame_type = FT_REGULAR
    fh.encoding = ENC_VARDCT
    fh.color_transform = CT_YCBCR
    fh.chroma_subsampling.channel_mode = [0, 1, 0]
    fh.flags = FLAG_SKIP_ADAPTIVE_DC_SMOOTHING
    fh.loop_filter.all_default = False
    fh.loop_filter.gab = True
    fh.loop_filter.epf_iters = 2
    ycbcr = rgb_to_ycbcr(np.moveaxis(_photo(h, w, 6).astype(np.float64)
                                     / 255, -1, 0))
    planes = [ycbcr[1]]
    for c in (0, 2):
        h2, w2 = h // 2 * 2, w // 2 * 2
        planes.insert(c, ycbcr[c][:h2, :w2].reshape(
            h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3)))
    encode_vardct_subsampled(wr, planes, fh, distance=1.0)
    return wr.get_bytes()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 256), (90, 100)],
                         ids=["aligned", "true-size-crop"])
def test_decode_filtered_ycbcr_on_card_matches_cpu(cuda, shape):
    """A 4:2:0 YCbCr frame with Gaborish and 2 EPF passes: render_tail
    filters the block-padded luma-size planes (no true-size mirror) and
    the crop follows BT.601. One render_tail launch, u8 within one step
    of the same render on the CPU (the twins)."""
    from libjxl_tpu_torch.api import codestream

    data = _filtered_ycbcr420(*shape)
    info, cinfo = {}, {}
    (got, _), n = _launched(codestream.decode, data, device=cuda,
                            decode_info=info)
    ref, _ = codestream.decode(data, device="cpu", decode_info=cinfo)
    assert info["path"] == cinfo["path"] == "device:u8-ycbcr"
    assert n == {"render_tail": 1}
    assert got.shape == ref.shape == (*shape, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def _entropy_streams(n, seed):
    """n distinct smooth 256x512 streams at d4: two AC groups each."""
    from libjxl_tpu_torch.api import codestream

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:256, 0:512]
    out = []
    for i in range(n):
        img = (128 + 50 * np.sin(xx * 0.013 + i) + 40 * np.cos(yy * 0.009)
               + rng.normal(0, 3, (256, 512)))
        rgb = np.stack([img, img * 0.92 + 8, img * 1.05 - 9], axis=-1)
        out.append(codestream.encode_lossy(
            np.clip(rgb, 0, 255).astype(np.uint8), distance=4.0, effort=3,
            device=None))
    return out


def _d4_lane_plan():
    """The lane plan of two 512x512 d4 streams (tests/test_ans_kernel.py's
    generator, chip_smoke.py's small set): 8 lanes, 4 an image."""
    from libjxl_tpu_torch.api import codestream, tpu_codec

    datas = []
    for seed in (7, 8):
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:512, 0:512]
        img = (128 + 50 * np.sin(xx * 0.013) + 40 * np.cos(yy * 0.009)
               + rng.normal(0, 3.0, (512, 512)))
        rgb = np.stack([img, img * 0.92 + 8, img * 1.05 - 9], axis=-1)
        datas.append(codestream.encode_lossy(
            np.clip(rgb, 0, 255).astype(np.uint8), distance=4.0, effort=3,
            device=None))
    return tpu_codec.prepare_batch_entropy(datas)[2]


def _k3_against_twin(cuda, lp):
    """ans_decode on the card and its twin on the CPU, one launch:
    (tape, ok, steps) of each, the kernel's first."""
    from libjxl_tpu_torch.ops import ans_kernel

    n = kernels.ANS_DECODE_LAUNCHES.count
    got = [x.cpu() for x in kernels.ans_decode(lp.to(cuda))]
    torch.cuda.synchronize()
    assert kernels.ANS_DECODE_LAUNCHES.count == n + 1
    return got, ans_kernel.ans_decode_plain(lp.to("cpu"))


@pytest.mark.cuda
def test_ans_decode_kernel_matches_plain(cuda):
    """K3 against its twin: the tape word for word, ok and steps."""
    from libjxl_tpu_torch.api import tpu_codec
    from libjxl_tpu_torch.ops import ans_kernel

    _, _, lp = tpu_codec.prepare_batch_entropy(_entropy_streams(2, 19))
    n = kernels.ANS_DECODE_LAUNCHES.count
    tape, ok, steps = kernels.ans_decode(lp.to(cuda))
    torch.cuda.synchronize()
    assert kernels.ANS_DECODE_LAUNCHES.count == n + 1
    rtape, rok, rsteps = ans_kernel.ans_decode_plain(lp.to("cpu"))
    assert rok.all()
    assert torch.equal(tape.cpu(), rtape)
    assert torch.equal(ok.cpu(), rok)
    assert torch.equal(steps.cpu(), rsteps)


@pytest.mark.cuda
def test_ans_decode_kernel_matches_plain_on_512_d4(cuda):
    """K3 on the two 512x512 d4 streams: each CTA stages the tables of
    the one image its lanes belong to."""
    from libjxl_tpu_torch.ops import ans_kernel

    lp = _d4_lane_plan()
    assert lp.n_lanes == 8
    firsts = ans_kernel.cta_first(lp.lane_img)
    assert firsts[0] == 0 and firsts[-1] == 8
    assert all(len(set(lp.lane_img[a:b])) == 1
               for a, b in zip(firsts, firsts[1:]))
    (tape, ok, steps), (rtape, rok, rsteps) = _k3_against_twin(cuda, lp)
    assert rok.all()
    assert torch.equal(tape, rtape)
    assert torch.equal(ok, rok) and torch.equal(steps, rsteps)


@pytest.mark.cuda
def test_ans_decode_kernel_flags_corrupt_lane_like_plain(cuda):
    """A seeded corruption of lane 5's stream: the kernel's tape, ok and
    steps equal the twin's, and only lane 5 is not ok."""
    lp = _d4_lane_plan()
    rng = np.random.default_rng(0)
    nhw = int(lp.lane_off[6] - lp.lane_off[5]) - 256  # less the slack
    idx = lp.lane_off[5] + rng.integers(0, nhw, 4)
    lp.flat_hw[idx] ^= rng.integers(1, 1 << 16, 4).astype(np.uint16)
    (tape, ok, steps), (rtape, rok, rsteps) = _k3_against_twin(cuda, lp)
    assert rok.tolist() == [i != 5 for i in range(8)]
    assert torch.equal(tape, rtape)
    assert torch.equal(ok, rok) and torch.equal(steps, rsteps)


@pytest.mark.cuda
def test_ans_decode_kernel_clamps_reads_past_the_end_like_plain(cuda):
    """The halfwords cut short inside the last lane's stream: its reads
    past the end clamp to the last halfword, in the stream ring's plain
    fill, as in the twin."""
    lp = _d4_lane_plan()
    lp.flat_hw = lp.flat_hw[:int(lp.lane_off[-1]) + 37].copy()
    lp.t_alloc = 4000  # above the lanes' 3,524 steps; bounds the cut lane
    (tape, ok, steps), (rtape, rok, rsteps) = _k3_against_twin(cuda, lp)
    assert rok[:7].all()
    assert torch.equal(tape, rtape)
    assert torch.equal(ok, rok) and torch.equal(steps, rsteps)


@pytest.mark.cuda
def test_decode_batch_entropy_on_card_matches_cpu(cuda):
    """The device-entropy path on the card: one ans_decode, one
    dequant_idct8 and one render_tail launch; the card's host-entropy batch
    exactly, the CPU's within one u8 step."""
    from libjxl_tpu_torch.api import tpu_codec
    from libjxl_tpu_torch.base.device import launch_counts

    streams = _entropy_streams(2, 20)
    before = launch_counts()
    got, info = tpu_codec.decode_batch_entropy(streams, cuda)
    after = launch_counts()
    assert info == {"path": "device_entropy"}
    assert {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == {
        "ans_decode": 1, "dequant_idct8": 1, "render_tail": 1}
    cpu, cinfo = tpu_codec.decode_batch_entropy(streams, "cpu")
    assert cinfo == {"path": "device_entropy"}
    for g, b, c in zip(got, tpu_codec.decode_batch(streams, cuda), cpu):
        assert g.shape == c.shape == (256, 512, 3)
        assert np.array_equal(g, b)
        assert np.abs(g.astype(int) - c.astype(int)).max() <= 1


# the TPU gather probes S1-S7 (libjxl_tpu_torch/probes) -----------------------

def _launches(fn, *args):
    from libjxl_tpu_torch.base.device import launch_counts

    before = launch_counts()
    out = fn(*args)
    after = launch_counts()
    return out, {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("form", gather.FORMS, ids=lambda f: f.name)
def test_probe_kernel_matches_twin(cuda, form):
    """Each S1-S5 form's kernel equals its twin exactly, on the scratch
    state and a seeded one: one launch each."""
    err, n = _launches(gather.check_form, form, cuda)
    assert err == 0
    assert n == {gather.PROBES[form.probe][0].name: 2}


@pytest.mark.cuda
def test_wl_pallas_kernel_matches_twin(cuda):
    """S6: row 0 after 560 launches, eager and replayed from a CUDA graph,
    equals the input's; every launch that ran is counted."""
    err, n = _launches(gather.check_wl_pallas, cuda)
    assert err == 0
    # per input: 560 eager, the graph's warm-up launch, 560 replayed
    assert n == {"wl_pallas": 2 * (2 * gather.WL_CALLS + 1)}


@pytest.mark.cuda
def test_glue_kernel_matches_twin(cuda):
    """S7: the stream-copy floor's tape equals its twin's word for word at
    ans_decode's step counts, and every lane is ok."""
    from libjxl_tpu_torch.api import tpu_codec
    from libjxl_tpu_torch.probes import prof_kernel

    _, _, lp = tpu_codec.prepare_batch_entropy(_entropy_streams(2, 21))
    lt = lp.to(cuda)
    _, _, steps = kernels.ans_decode(lt)
    (tape, ok), n = _launches(prof_kernel.glue, lt, steps)
    torch.cuda.synchronize()
    assert n == {"glue": 1}
    rtape, rok = prof_kernel.glue_plain(lt, steps)
    assert ok.all() and rok.all()
    assert torch.equal(tape, rtape)
    assert (tape[int(steps.max()):] == 0).all()


def _encode_arrays(img, device):
    """encode_lossy_tpu's bytes and its step's arrays as read back."""
    from libjxl_tpu_torch.api import tpu_codec

    got = {}

    def mark(stage, value):
        if stage == "readback":
            got["arrays"] = value

    data = tpu_codec.encode_lossy_tpu(img, device=device, mark=mark)
    return data, got["arrays"]


@pytest.mark.cuda
def test_encode_on_card_matches_cpu(cuda):
    """encode_lossy's device route on the card: no kernel launch (the
    encode step is torch ops), the step's arrays as on the CPU except
    integers one step off at a rounding boundary (fewer than 1 in 10,000)
    and floats within 1e-5, and the stream decodes within one u8 step of
    its host decode."""
    from libjxl_tpu_torch.api import codestream

    img = _photo(256, 320, 12)
    (data, card), n = _launched(_encode_arrays, img, cuda)
    assert n == {}
    _, cpu = _encode_arrays(img, "cpu")
    for a, b in zip(card, cpu):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        else:
            d = np.abs(a.astype(np.int64) - b.astype(np.int64))
            assert d.max() <= 1 and (d != 0).sum() <= max(1, a.size // 10000)
    assert codestream.encode_lossy(img, effort=3, device=cuda) == data
    got, _ = codestream.decode(data, device=cuda)
    ref, _ = codestream.decode(data, device=None)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.cuda
def test_streaming_on_card_is_the_same_for_any_hosts(cuda):
    """encode_lossy_streaming on the card: hosts=1 and hosts=2 (threads
    sharing the card) give equal bytes; no kernel launch."""
    from libjxl_tpu_torch.api import codestream

    img = _photo(300, 260, 13)
    one, n = _launched(codestream.encode_lossy_streaming, img, device=cuda)
    assert n == {}
    assert codestream.encode_lossy_streaming(img, hosts=2,
                                             device=cuda) == one
    out, _ = codestream.decode(one, device=None)
    assert np.abs(out.astype(int) - img.astype(int)).mean() < 6.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(600, 520), (257, 1030)])
def test_decode_rows_on_card_matches_cpu(cuda, shape):
    """decode_rows on the card: u8 strips, dequant_idct8 and render_tail
    once a strip, the rows within one step of the CPU's strips (the
    twins) and of the whole-image decode on the card."""
    from libjxl_tpu_torch.api import codestream

    data = codestream.encode_lossy(_photo(*shape, 14), distance=1.0,
                                   effort=3, device=None)
    rows, n = _launched(lambda: list(codestream.decode_rows(data,
                                                            device=cuda)))
    assert all(r.dtype == np.uint8 for _, r in rows)
    assert n == {"dequant_idct8": len(rows), "render_tail": len(rows)}
    got = np.concatenate([r for _, r in rows], axis=0)
    cpu = np.concatenate([r for _, r in codestream.decode_rows(
        data, device="cpu")], axis=0)
    whole, _ = codestream.decode(data, device=cuda)
    for ref in (cpu, whole):
        assert got.shape == ref.shape
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("effort,rounds", [(5, 0), (7, 2)])
def test_encode_heuristics_on_card_launch_render_tail_once_a_round(
        cuda, effort, rounds):
    """encode_lossy on the card at e5 (the tile costs) and e7 (with the
    butteraugli refinement): render_tail once a refinement round, as the
    trial's Gaborish + EPF, and nothing else; the stream decodes close to
    the image."""
    from libjxl_tpu_torch.api import codestream

    img = _photo(192, 224, 15)
    data, n = _launched(codestream.encode_lossy, img, distance=1.0,
                        effort=effort, device=cuda)
    assert n == ({"render_tail": rounds} if rounds else {})
    out, _ = codestream.decode(data, device=None)
    assert np.abs(out.astype(int) - img.astype(int)).mean() < 6.0


@pytest.mark.cuda
def test_heuristics_torch_forms_on_card_match_cpu(cuda):
    """butteraugli_diffmap_torch and _tile_cost_device on the card against
    the same functions on the CPU: the diffmap within 2e-3 relative (1e-3
    floor; tests/test_butteraugli_jax.py's device-vs-host bound: the card
    sums the blur products in another order and the opsin X channel
    cancels), the costs within rtol 1e-5 but for at most one tile a size
    (a coefficient on its rounding boundary moves its tile's bits)."""
    from libjxl_tpu_torch.io.frame_header import FrameHeader
    from libjxl_tpu_torch.io.headers import CodecMetadata, SizeHeader
    from libjxl_tpu_torch.metrics.butteraugli_torch import (
        butteraugli_diffmap_torch)
    from libjxl_tpu_torch.vardct import ac_strategy as acs
    from libjxl_tpu_torch.vardct.frame import VarDCTState, _tile_cost_device

    rng = np.random.default_rng(16)
    a = rng.uniform(0, 1, (3, 96, 136)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.01, a.shape), 0, 1).astype(np.float32)
    got = butteraugli_diffmap_torch(_t(a).to(cuda), _t(b).to(cuda)).cpu()
    ref = butteraugli_diffmap_torch(_t(a), _t(b))
    assert float(((got - ref).abs() / (ref.abs() + 1e-3)).max()) <= 2e-3
    meta = CodecMetadata()
    meta.size = SizeHeader().set(136, 96)
    fh = FrameHeader(meta)
    state = VarDCTState(fh, fh.frame_dimensions())
    state.quantizer.compute_global_scale_and_quant(1.0, 2.0)
    state.raw_quant_field[:] = rng.integers(5, 40, state.raw_quant_field.shape)
    xyb = rng.normal(0, 0.2, (3, 96, 136)).astype(np.float32)
    for rows, cols, s in ((8, 8, acs.DCT), (32, 16, acs.DCT32X16),
                          (64, 64, acs.DCT64X64)):
        args = (xyb, rows, cols, acs.QUANT_TABLE[s], 96 // rows, 136 // cols)
        got = _tile_cost_device(state, *args, cuda)
        ref = _tile_cost_device(state, *args, torch.device("cpu"))
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert (np.abs(got - ref) > 1e-5 * np.abs(ref)).sum() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("epf_iters", [2, 3])
def test_sharded_full_decode_on_a_virtual_mesh_matches_unsharded(cuda,
                                                                 epf_iters):
    """build_sharded_decode_full on a (batch 2, rows 2) mesh of four
    entries of cuda:0 against the same builder on a 1-entry mesh and
    against dequant_idct8 + render_tail + xyb_to_rgb over the whole batch:
    one launch of each kernel a shard, the kernels' rows equal wherever
    the shard sits. (Against the CPU twins the linear RGB moves by more
    than the chain's tolerance where the cubes amplify an ulp of XYB:
    the builder's global scale 1024 puts these XYB values in the tens.)"""
    from libjxl_tpu_torch.parallel import sharding

    rng = np.random.default_rng(90 + epf_iters)
    b, h, w = 2, 256, 192
    q, qf, dc, ytox, ytob, dm, _ = _dequant_inputs(91, b, h, w)
    isg = rng.uniform(-2.5, -0.3, (b, h // 8, w // 8)).astype(np.float32)
    ispx = np.repeat(np.repeat(isg, 8, 1), 8, 2)
    sad = _sad_mul_map(h, w, 2.0 / 3.0).astype(np.float32)
    args = (q, qf, dc, ytox, ytob, dm, ispx, sad)
    mesh = sharding.Mesh.of(cuda, 4, batch=2)
    got, n = _launched(sharding.build_sharded_decode_full(
        mesh, epf_iters=epf_iters), *args)
    assert n == {"dequant_idct8": 4, "render_tail": 4}
    one, n = _launched(sharding.build_sharded_decode_full(
        sharding.Mesh.of(cuda, 1), epf_iters=epf_iters), *args)
    assert n == {"dequant_idct8": 1, "render_tail": 1}
    assert got.device == cuda and got.shape == (b, 3, h, w)
    np.testing.assert_array_equal(got.cpu().numpy(), one.cpu().numpy())
    q, qf, dc, ytox, ytob, dm = (_t(a).to(cuda) for a in args[:6])
    xyb = kernels.dequant_idct8(q, qf, dc, ytox, ytob, dm,
                                torch.full((b,), 1024.0, device=cuda), 1.0,
                                1.0)
    gab = np.stack([gaborish_kernel(*sharding.GAB_DEFAULT[c])
                    for c in range(3)]).astype(np.float32)
    ref = tpl.xyb_to_rgb(kernels.render_tail(
        xyb, _t(gab).to(cuda), _t(isg).to(cuda), _t(sad).to(cuda),
        sharding.FULL_CHANNEL_SCALE, epf_iters, out="xyb"))
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_sharded_stream_render_and_serving_decode_on_a_virtual_mesh(cuda):
    """A real 512x512 stream rendered with its rows over 4 entries of
    cuda:0 equals the single-device render exactly (four launches of each
    kernel); decode_batch_sharded of 4 streams over the same mesh equals
    decode_batch, one launch of each kernel a shard."""
    from libjxl_tpu_torch.api import codestream, tpu_codec
    from libjxl_tpu_torch.parallel import dryrun, sharding

    mesh = sharding.Mesh.of(cuda, 4)
    sr = dryrun.StreamRender.of(codestream.encode_lossy(
        dryrun.photo(512, np.random.default_rng(7)), distance=1.0,
        effort=3, device=None))
    got, n = _launched(sr.sharded(mesh), *sr.args)
    assert n == {"dequant_idct8": 4, "render_tail": 4}
    single = sr.single(cuda)
    assert torch.equal(got.permute(1, 2, 0), single)
    rng = np.random.default_rng(92)
    streams = [codestream.encode_lossy(
        np.clip(rng.normal(120, 30, (96, 136, 3)), 0, 255).astype(np.uint8),
        distance=1.0, effort=3, device=None) for _ in range(4)]
    outs, n = _launched(tpu_codec.decode_batch_sharded, streams, mesh)
    assert n == {"dequant_idct8": 4, "render_tail": 4}
    for g, r in zip(outs, tpu_codec.decode_batch(streams, cuda)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.cuda
def test_djxl_on_card_renders_through_the_kernels(cuda, tmp_path):
    """djxl by default on the card: one dequant_idct8 and one render_tail
    for a two-group e5 frame, within one u8 step of djxl --host."""
    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.extras.io import load_image
    from libjxl_tpu_torch.tools import djxl

    src = tmp_path / "a.jxl"
    src.write_bytes(codestream.encode_lossy(_photo(256, 320, 16),
                                            distance=1.0, effort=5,
                                            device=None))
    rc, n = _launched(djxl.main, [str(src), str(tmp_path / "card.ppm")])
    assert rc == 0 and n == {"dequant_idct8": 1, "render_tail": 1}
    assert djxl.main([str(src), str(tmp_path / "host.ppm"), "--host"]) == 0
    got = load_image(tmp_path / "card.ppm").astype(int)
    assert np.abs(got - load_image(tmp_path / "host.ppm")).max() <= 1


@pytest.mark.cuda
def test_cjxl_e7_on_card_equals_encode_lossy(cuda, tmp_path):
    """cjxl -e 7 on the card: render_tail once a refinement round (2), and
    the bytes of encode_lossy(..., effort=7) on the card."""
    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.extras.io import save_image
    from libjxl_tpu_torch.tools import cjxl

    img = _photo(192, 224, 17)
    save_image(tmp_path / "in.ppm", img)
    out = tmp_path / "out.jxl"
    rc, n = _launched(cjxl.main, [str(tmp_path / "in.ppm"), str(out), "-e",
                                  "7"])
    assert rc == 0 and n == {"render_tail": 2}
    assert out.read_bytes() == codestream.encode_lossy(img, distance=1.0,
                                                       effort=7, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("target", ["decode", "container", "encode"])
def test_fuzz_target_on_card_has_no_findings(cuda, target):
    """The fuzz harness on the card (tests/test_conformance_fuzz.py's 25
    iterations): no finding, and the kernels still agree with their twins
    afterwards (a fuzzed launch that faulted would leave a sticky error)."""
    from libjxl_tpu_torch.tools import fuzz

    stats = {}
    assert fuzz.run(target, iters=25, seed=1234, device=cuda,
                    stats=stats) == 0
    assert stats["inputs"] == 25
    if target == "encode":
        assert stats["reached_kernel"] > 0
    test_render_tail_kernel_matches_plain(cuda, 2, True, (40, 136))


@pytest.mark.cuda
def test_conformance_check_on_card(cuda, tmp_path):
    """A small corpus generated on the card (an e5 and an e7 photo, a
    lossless case) passes `conformance check` on the card and on the
    host; the card's check renders each VarDCT case with one
    dequant_idct8 and one render_tail."""
    import contextlib
    import io

    from libjxl_tpu_torch.extras.io import save_image
    from libjxl_tpu_torch.tools import conformance

    for name, (h, w, seed) in {"e5": (256, 320, 20), "e7": (192, 224, 21),
                               "ll": (64, 80, 22)}.items():
        save_image(tmp_path / f"{name}.ppm", _photo(h, w, seed))
    for name, extra in (("e5", ["-e", "5"]), ("e7", ["-e", "7", "-d", "2"]),
                        ("ll", ["--lossless"])):
        assert conformance.main(["generate", str(tmp_path / f"{name}.ppm"),
                                 "--out", str(tmp_path / "corpus"),
                                 *extra]) == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, n = _launched(conformance.main,
                          ["check", str(tmp_path / "corpus"), "-v"])
    assert rc == 0 and "3/3 cases pass" in out.getvalue()
    assert n == {"dequant_idct8": 2, "render_tail": 2}
    rc, n = _launched(conformance.main, ["check", str(tmp_path / "corpus"),
                                         "--host"])
    assert rc == 0 and n == {}


def _block_inputs(seed, b, nby, nbx):
    """_dequant_inputs in the block layout [b, 3, nby, nbx, 8, 8], with a
    per-block EPF sigma expanded per pixel and the encoder's SAD map and
    Gaborish."""
    q, qf, dc, ytox, ytob, dm, igs = _dequant_inputs(seed, b, nby * 8,
                                                     nbx * 8)
    blocks = q.reshape(b, 3, nby, 8, nbx, 8).transpose(0, 1, 2, 4, 3, 5)
    _, isg, gab, sad = _tail_inputs(seed, b, nby * 8, nbx * 8)
    ispx = np.repeat(np.repeat(isg, 8, 1), 8, 2)
    return (blocks, qf, dc, ytox, ytob, dm, igs), ispx, gab, sad


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
def test_decode_pixels_hybrid_on_card_matches_its_twin(cuda, batch):
    """One dequant_idct8 launch a call, its XYB within K1's bound of
    pipeline.decode_xyb, the route's RGB that XYB's colour transform;
    non-default CfL constants raise on the card too."""
    args, _, _, _ = _block_inputs(93, batch, 20, 33)
    if batch == 1:  # one image, one global scale
        args = [_t(a[0]).to(cuda) for a in args[:5]] + [
            _t(args[5]).to(cuda), float(args[6][0])]
    else:
        args = [_t(a).to(cuda) for a in args]
    got, n = _launched(kernels.decode_pixels_hybrid, *args, 0.8, 1.25)
    assert n == {"dequant_idct8": 1}
    xyb = kernels.dequant_idct8(*kernels._image_args(*args, 0.8, 1.25))
    torch.testing.assert_close(xyb, tpl.decode_xyb(*args, 0.8, 1.25),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got, tpl.xyb_to_rgb(xyb))
    with pytest.raises(ValueError, match="fixes color_factor"):
        kernels.decode_pixels_hybrid(*args, base_x=0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("gab", [False, True], ids=["nogab", "gab"])
@pytest.mark.parametrize("epf_iters", [0, 2, 3])
def test_decode_render_blocks_on_card_equals_the_image_layout(cuda,
                                                              epf_iters,
                                                              gab):
    """The block-layout render is the image-layout render of the same
    coefficients (the same launches on the same data, so equal), one
    dequant_idct8 and one render_tail unless there is no filter; its
    XYB within the chain's bound of pipeline.decode_render."""
    (blocks, qf, dc, ytox, ytob, dm, igs), ispx, gabk, sad = _block_inputs(
        94, 2, 16, 24)
    t = [_t(a).to(cuda) for a in (blocks, qf, dc, ytox, ytob, dm, igs,
                                  ispx, sad)]
    gabk = _t(gabk).to(cuda) if gab else None
    args = (*t[:7], 1.0, 1.0, gabk, t[7], t[8], CS, epf_iters)
    got, n = _launched(kernels.decode_render_blocks, *args)
    want = {"dequant_idct8": 1}
    if gab or epf_iters:
        want["render_tail"] = 1
    assert n == want
    qimg = tpl.blocks_to_image(t[0]).contiguous()
    ref = tpl.decode_render_image(qimg, *t[1:7], 1.0, 1.0, gabk,
                                  _t(ispx[:, ::8, ::8]).to(cuda), t[8], CS,
                                  epf_iters)
    if gab or epf_iters:
        assert torch.equal(got, ref)
    xyb = kernels.decode_render_blocks(*args, to_rgb=False)
    torch.testing.assert_close(
        xyb, tpl.decode_render(*args, to_rgb=False),
        **chain_tol(gab, epf_iters))


@pytest.mark.cuda
def test_sharded_block_decode_on_a_virtual_mesh_equals_unsharded(cuda):
    """build_sharded_decode on a (batch 2, rows 2) mesh of four entries of
    cuda:0 with per-tile CfL maps, each row shard two whole tiles: one
    dequant_idct8 launch a shard, equal to the same builder on a 1-entry
    mesh; the dry run's step on the same mesh."""
    from libjxl_tpu_torch.parallel import dryrun, sharding

    (blocks, qf, dc, ytox, ytob, dm, _), _, _, _ = _block_inputs(95, 2, 32,
                                                                 16)
    args = (blocks, qf, dc, ytox, ytob, dm)
    mesh = sharding.Mesh.of(cuda, 4, batch=2)
    got, n = _launched(sharding.build_sharded_decode(mesh), *args)
    assert n == {"dequant_idct8": 4}
    one, n = _launched(sharding.build_sharded_decode(
        sharding.Mesh.of(cuda, 1)), *args)
    assert n == {"dequant_idct8": 1}
    assert got.device == cuda and tuple(got.shape) == (2, 3, 256, 128)
    assert torch.equal(got, one)
    rec, n = _launched(dryrun.dryrun_codec_step, mesh,
                       np.random.default_rng(1))
    assert n == {"dequant_idct8": 5}  # 4 shards + the unsharded decode
    assert rec["block_decode"]["max_abs_err"] <= 1e-3


@pytest.mark.cuda
def test_entry_on_card_matches_its_twin(cuda):
    from libjxl_tpu_torch import entry

    fn, args = entry.entry()
    assert all(a.device == cuda for a in args)
    got, n = _launched(fn, *args)
    assert n == {"dequant_idct8": 1} and tuple(got.shape) == (3, 256, 256)
    xyb = kernels.dequant_idct8(
        *kernels._image_args(*args, 1024.0, 1.0, 1.0))
    torch.testing.assert_close(xyb, tpl.decode_xyb(*args, 1024.0, 1.0, 1.0),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got, tpl.xyb_to_rgb(xyb))


# the program layer (libjxl_tpu_torch/ops/programs.py) ---------------------

def _same(a, b) -> bool:
    """Bitwise equality of two program results (arrays, tensors, bytes
    and tuples of them)."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _three_calls(name, fn, *args, **kw):
    """fn(*args, **kw) three times through the program `name`, from an
    empty cache: eager, capture + replay, replay. Returns the program, the
    three results and the launches of each."""
    from libjxl_tpu_torch.ops import programs

    programs.clear()
    outs, launches = [], []
    for _ in range(3):
        out, n = _launched(fn, *args, **kw)
        outs.append(out)
        launches.append(n)
    progs = [p for p in programs.programs(torch.device("cuda", 0))
             if p.name == name]
    assert len(progs) == 1, [p.name for p in progs]
    return progs[0], outs, launches


def _program_cases():
    """(program name, fn, args) for each of the port's programs, on small
    inputs."""
    from libjxl_tpu_torch.api import codestream, tpu_codec
    from libjxl_tpu_torch.vardct import streaming
    import pathlib

    rng = np.random.default_rng(23)
    batch = [codestream.encode_lossy(
        np.clip(rng.normal(120, 30, (100, 132, 3)), 0, 255).astype(np.uint8),
        distance=1.0, effort=3, device=None) for _ in range(2)]
    e5 = codestream.encode_lossy(_photo(256, 256, 3), distance=1.0, effort=5,
                                 device=None)
    jpeg = (pathlib.Path(__file__).resolve().parent / "data"
            / "conformance" / "jpeg_recon.jxl").read_bytes()
    (blocks, qf, dc, ytox, ytob, dm, igs), ispx, gabk, sad = _block_inputs(
        96, 2, 16, 24)
    t = [_t(a).to("cuda") for a in (blocks, qf, dc, ytox, ytob, dm, igs,
                                    ispx, sad, gabk)]
    chunk = rng.uniform(0, 1, (3, 136, 152)).astype(np.float32)
    step = (rng.normal(0, 0.1, (3, 128, 128)).astype(np.float32),
            rng.uniform(0.5, 2, (3, 8, 8)).astype(np.float32),
            rng.uniform(0.5, 2, (3, 8, 8)).astype(np.float32),
            0.125, 9.0, 1.0, 1.0,
            rng.integers(1, 30, (16, 16)).astype(np.int32), "cuda")
    return {
        "batch": (tpu_codec.decode_batch, (batch, "cuda")),
        "dec_image": (lambda d: codestream.decode(d, device="cuda")[0],
                      (e5,)),
        "dec_sub": (lambda d: codestream.decode(d, device="cuda")[0],
                    (jpeg,)),
        "enc": (tpu_codec.encode_lossy_tpu, (_photo(128, 160, 4), 1.0)),
        "chunk_prep": (streaming.prep, (chunk, "cuda")),
        "chunk_step": (streaming.step, step),
        "dec": (kernels.decode_pixels_hybrid, (*t[:7], 0.8, 1.0)),
        "dec_full": (kernels.decode_render_blocks,
                     (*t[:7], 1.0, 1.0, t[9], t[7], t[8], CS, 2)),
        "entropy": (lambda s: tpu_codec.decode_batch_entropy(s, "cuda")[0],
                    (_entropy_streams(2, 24),)),
    }


PROGRAMS = ("batch", "dec_image", "dec_sub", "enc", "chunk_prep",
            "chunk_step", "dec", "dec_full", "entropy")


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROGRAMS)
def test_program_replay_equals_its_eager_call(cuda, name):
    """Each program's replay is its eager call bitwise, with the same
    launches: the counters count each replay as its capture recorded."""
    fn, args = _program_cases()[name]
    prog, outs, launches = _three_calls(name, fn, *args)
    assert prog.mode == "replay" and prog.calls == 3
    assert prog.capture_s is not None
    # what the program holds: its slots and its graph's pool
    assert prog.held >= sum(t.untyped_storage().nbytes()
                            for t in prog.slots) > 0
    assert _same(outs[0], outs[1]) and _same(outs[0], outs[2])
    assert launches[0] == launches[1] == launches[2]
    assert prog.launches == {k: v for k, v in launches[0].items()
                             if k in prog.launches}


@pytest.mark.cuda
def test_entropy_program_replays_a_batch_of_other_images(cuda):
    """Batches of other images of one geometry share the "entropy"
    program: the first runs eagerly, the second (other images) captures
    and replays, the first again replays; each equals the host-entropy
    batch exactly."""
    from libjxl_tpu_torch.api import tpu_codec
    from libjxl_tpu_torch.ops import programs

    programs.clear()
    a, b = _entropy_streams(2, 24), _entropy_streams(2, 25)
    for streams in (a, b, a):
        got, info = tpu_codec.decode_batch_entropy(streams, "cuda")
        assert info == {"path": "device_entropy"}
        for g, h in zip(got, tpu_codec.decode_batch(streams, "cuda")):
            assert np.array_equal(g, h)
    (prog,) = [p for p in programs.programs(cuda) if p.name == "entropy"]
    assert prog.mode == "replay" and prog.calls == 3


@pytest.mark.cuda
def test_program_keeps_callers_outputs(cuda):
    """A caller's outputs are its own: the next replay of the program
    does not overwrite them."""
    from libjxl_tpu_torch.ops import programs

    programs.clear()
    x = [torch.full((4,), float(i), device=cuda) for i in range(4)]
    outs = [programs.run("double", (), lambda v: v * 2, xi, device=cuda)
            for xi in x]
    torch.cuda.synchronize()
    assert [o.tolist() for o in outs] == [[2.0 * i] * 4 for i in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("unsafe", ["item", "upload"])
def test_capture_unsafe_program_raises(cuda, unsafe):
    """A body that syncs with the host or uploads runs at its eager first
    call, and its capture raises: nothing falls back to an eager run."""
    from libjxl_tpu_torch.ops import programs

    programs.clear()

    def body(v):
        if unsafe == "item":
            return v * float(v.sum())
        return v + torch.as_tensor(np.ones(4, np.float32), device=v.device)

    x = torch.ones(4, device=cuda)
    programs.run("unsafe", (), body, x, device=cuda)
    with pytest.raises(RuntimeError):
        programs.run("unsafe", (), body, x, device=cuda)
    (prog,) = programs.programs(cuda)
    assert prog.graph is None


def _heuristics_state(h, w, seed):
    """An encoder state of an h x w frame with a seeded raw quant field,
    and a seeded opsin image: the tile cost's inputs."""
    from libjxl_tpu_torch.io.frame_header import FrameHeader
    from libjxl_tpu_torch.io.headers import CodecMetadata, SizeHeader
    from libjxl_tpu_torch.vardct.frame import VarDCTState

    rng = np.random.default_rng(seed)
    meta = CodecMetadata()
    meta.size = SizeHeader().set(w, h)
    fh = FrameHeader(meta)
    state = VarDCTState(fh, fh.frame_dimensions())
    state.quantizer.compute_global_scale_and_quant(1.0, 2.0)
    state.raw_quant_field[:] = rng.integers(5, 40,
                                            state.raw_quant_field.shape)
    return state, rng.normal(0, 0.2, (3, h, w)).astype(np.float32)


def _heuristics_cases(cuda):
    """(program name, fn, args) of the encoder heuristics' programs on
    small inputs: a tile size, the refinement's trial (Gaborish and two
    EPF passes), the diffmap."""
    from libjxl_tpu_torch.metrics.butteraugli_torch import (
        butteraugli_diffmap_torch)
    from libjxl_tpu_torch.ops import programs
    from libjxl_tpu_torch.vardct import ac_strategy as acs
    from libjxl_tpu_torch.vardct import heuristics
    from libjxl_tpu_torch.vardct.frame import _tile_cost_device

    state, xyb = _heuristics_state(96, 136, 17)
    rng = np.random.default_rng(18)
    nby, nbx = 12, 17
    co = rng.normal(0, 0.05, (3, nby, nbx, 8, 8)).astype(np.float32)
    dm = rng.uniform(3e-4, 0.01, (3, 8, 8)).astype(np.float32)
    xyb_t, isg, gab, sad = _tail_inputs(19, 1, nby * 8, nbx * 8)
    trial_args = [_t(a).to(cuda) for a in (
        co, co[:, :, :, 0, 0].copy(), dm, 1.0 / dm,
        tpl._consts()["inv8"], gab, sad)]
    qfr = rng.integers(2, 30, (nby, nbx)).astype(np.float32)

    def trial():
        co_t, dc_t, dm_t, dmi_t, i8, gab_t, sad_t = trial_args
        return programs.run(
            "trial", (True, 2), heuristics._trial, co_t, dc_t, qfr, dm_t,
            dmi_t, np.asarray(0.125, np.float32), i8, gab_t, isg[0], sad_t,
            CS, 0.9, 6.5, 2, device=cuda)

    a = rng.uniform(0, 1, (3, 96, 136)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.01, a.shape), 0, 1).astype(np.float32)
    return {
        "tile_cost": (_tile_cost_device, (
            state, xyb, 32, 16, acs.QUANT_TABLE[acs.DCT32X16], 3, 8, cuda)),
        "trial": (trial, ()),
        "diffmap": (butteraugli_diffmap_torch, (_t(a).to(cuda),
                                                _t(b).to(cuda))),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tile_cost", "trial", "diffmap"])
def test_heuristics_program_replay_equals_its_eager_call(cuda, name):
    """The encoder heuristics' programs (a tile size, the trial, the
    diffmap): each replay is its eager call bitwise, with the same
    launches (render_tail once a trial)."""
    fn, args = _heuristics_cases(cuda)[name]
    prog, outs, launches = _three_calls(name, fn, *args)
    assert prog.mode == "replay" and prog.calls == 3
    assert _same(outs[0], outs[1]) and _same(outs[0], outs[2])
    assert launches[0] == launches[1] == launches[2] == (
        {"render_tail": 1} if name == "trial" else {})


def _builder_cases(devices):
    """(program name, the builder's run, its arguments, launches a call)
    of each sharded builder on a (batch 2, rows 2) mesh of four entries
    of `devices` (the chunk step, the stream render and the serving
    decode on 4 rows)."""
    from libjxl_tpu_torch.api import codestream, tpu_codec
    from libjxl_tpu_torch.parallel import dryrun, sharding
    from libjxl_tpu_torch.vardct.quant_weights import library_tables

    mesh = sharding.make_mesh(devices, batch=2)
    rows = sharding.make_mesh(devices)
    rng = np.random.default_rng(97)
    b, h, w = 2, 256, 192
    q, qf, dc, ytox, ytob, dm, _ = _dequant_inputs(98, b, h, w)
    isg = rng.uniform(-2.5, -0.3, (b, h // 8, w // 8)).astype(np.float32)
    ispx = np.repeat(np.repeat(isg, 8, 1), 8, 2)
    sad = _sad_mul_map(h, w, 2.0 / 3.0).astype(np.float32)
    (blocks, bqf, bdc, bx, bb, bdm, _), _, _, _ = _block_inputs(99, 2, 32, 16)
    dm_t, dm_inv = (a.astype(np.float32) for a in library_tables()[0])
    sr = dryrun.StreamRender.of(codestream.encode_lossy(
        dryrun.photo(256, np.random.default_rng(7)), distance=1.0, effort=3,
        device=None))
    xyb = rng.normal(0, 0.1, (3, 256, 64)).astype(np.float32)
    step_qf = rng.integers(8, 40, (32, 8)).astype(np.int32)
    k1k2 = {"dequant_idct8": 4, "render_tail": 4}
    streams = [codestream.encode_lossy(
        np.clip(rng.normal(120, 30, (96, 136, 3)), 0, 255).astype(np.uint8),
        distance=1.0, effort=3, device=None) for _ in range(4)]
    return {
        "sharded_full": (sharding.build_sharded_decode_full(mesh),
                         (q, qf, dc, ytox, ytob, dm, ispx, sad), k1k2),
        "sharded_stream": (sr.sharded(rows), sr.args, k1k2),
        "sharded_decode": (sharding.build_sharded_decode(mesh),
                           (blocks, bqf, bdc, bx, bb, bdm),
                           {"dequant_idct8": 4}),
        "sharded_encode": (sharding.build_sharded_encode(mesh), (
            rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32),
            rng.integers(32, 96, (2, 8, 8)).astype(np.int32), dm_inv,
            dm_t[1], np.array([512.0, 64.0, 32.0], np.float32)), {}),
        "sharded_chunk": (sharding.make_sharded_chunk_step(rows), (
            xyb, dm_inv, dm_t, 8.716, 19.0, 1.0, 1.0, step_qf), {}),
        "batch": (tpu_codec.decode_batch_sharded, (streams, rows), k1k2),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sharded_full", "sharded_stream",
                                  "sharded_decode", "sharded_encode",
                                  "sharded_chunk", "batch"])
def test_sharded_builder_programs_replay_their_eager_call(cuda, name):
    """Each sharded builder's programs (a phase a mesh entry), on four
    entries of the cards in turn (four real cards where the machine has
    them, else a virtual mesh of cuda:0), and decode_batch_sharded's
    "batch" programs: three calls from an empty cache, eager, capture +
    replay, replay; every program replays, each call equals the first
    bitwise, with the launches of the eager call."""
    from libjxl_tpu_torch.ops import programs
    from libjxl_tpu_torch.parallel import dryrun

    devices = dryrun.mesh_devices(4, "cuda")
    run, args, want = _builder_cases(devices)[name]
    programs.clear()
    outs, launches = [], []
    for _ in range(3):
        out, n = _launched(run, *args)
        outs.append(tuple(out) if isinstance(out, (tuple, list)) else out)
        launches.append(n)
    cards = set(devices)
    progs = [p for d in cards for p in programs.programs(d)
             if p.name == name]
    if name == "batch":  # one program a card, shared by its entries
        assert len(progs) == len(cards)
    else:
        phases = 2 if name in ("sharded_full", "sharded_stream",
                               "sharded_decode") else 1
        assert len(progs) == 4 * phases
    # a builder's program runs once a call; a card's "batch" program once
    # for each of its entries
    calls = 3 * (4 // len(cards) if name == "batch" else 1)
    assert all(p.mode == "replay" and p.calls == calls for p in progs)
    assert _same(outs[0], outs[1]) and _same(outs[0], outs[2])
    assert launches == [want] * 3


@pytest.mark.cuda
def test_a_launch_on_another_card_keeps_the_current_device(cuda):
    """K1 and K2 launched on the last card while the first is current
    leave the first current: PyTorch places every call that names no card
    on the current device, and a sharded builder launches on every card
    of its mesh."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", torch.cuda.device_count() - 1)
    xyb, isg, gab, sad = (_t(a).to(other)
                          for a in _tail_inputs(18, 1, 40, 136))
    with torch.cuda.device(cuda):
        got = kernels.dequant_idct8(
            *[_t(a).to(other) for a in _dequant_inputs(19, 1, 64, 64)],
            0.8, 1.0)
        assert torch.cuda.current_device() == cuda.index
        out = kernels.render_tail(xyb, gab, isg, sad, CS, 2, out="xyb")
        assert torch.cuda.current_device() == cuda.index
    assert got.device == out.device == other
