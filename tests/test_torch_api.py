"""The port's user-facing library layers against the JAX package's:
extras/{io, exr, mmapio}, metrics (ssimulacra2 and the package exports),
api/stats.save_heatmap, and the libjxl-style Decoder and Encoder of
api/decoder.py and api/encoder.py.

Tolerances (ROADMAP.md, "How checked against works"): host routes equal
the JAX package's exactly (bytes, arrays, event sequences); a render on
the kernels' plain twins (device="cpu") is within 1 u8 step of the host
decode; ssimulacra2, the same float64 NumPy on both sides, within 1e-9.
The JAX side runs on CPU-JAX, where its accelerator probe picks its host
routes, the port's device=None.
"""

import numpy as np
import pytest
import torch

from libjxl_tpu.api import codestream as jcs
from libjxl_tpu.api import decoder as jdec
from libjxl_tpu.api import encoder as jenc
from libjxl_tpu.base.status import JXLError as JJXLError
from libjxl_tpu.extras import io as jio
from libjxl_tpu.extras.mmapio import read_mapped as jread_mapped
from libjxl_tpu.jpeg.recompress import recompress_jpeg_vardct
from libjxl_tpu.metrics import ssimulacra2 as jss2
from libjxl_tpu_torch import metrics as tmetrics
from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.api import decoder as tdec
from libjxl_tpu_torch.api import encoder as tenc
from libjxl_tpu_torch.api import stats as tstats
from libjxl_tpu_torch.base.status import JXLError
from libjxl_tpu_torch.extras import io as tio
from libjxl_tpu_torch.extras.mmapio import read_mapped
from libjxl_tpu_torch.jpegli import encode_jpegli

U8_BOUND = 1  # u8 steps from the host decode (tests/test_decode_batch.py)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The twins' torch ops on one thread: tier-1 runs six test processes
    on the machine's cores, and torch's own thread pool in each of them
    made the e7 diffmap 100x slower there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_card():
    """Decided in the test, not at import: the tests that check the error
    the default device raises need a machine without a card."""
    if torch.cuda.is_available():
        pytest.skip("checks the error raised without a card")


def _image(h, w, seed, c=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([100 + 80 * np.sin(xx * 0.04),
                    120 + 60 * np.cos(yy * 0.05),
                    90 + 70 * np.sin((xx + yy) * 0.02),
                    200 - 50 * np.cos(xx * 0.03)][:c], -1)
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(
        np.uint8)


def _near(got, ref, bound=U8_BOUND):
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= bound


# ------------------------------------------------------------- extras, io
IO_CASES = {
    "ppm": (".ppm", lambda: _image(40, 56, 1)),
    "ppm16": (".ppm", lambda: _image(40, 56, 2).astype(np.uint16) * 257),
    "pgm": (".pgm", lambda: _image(40, 56, 3, 1)),
    "pgx16": (".pgx", lambda: (_image(24, 40, 4, 1).astype(np.uint16) * 3)),
    "pfm": (".pfm", lambda: _image(24, 40, 5).astype(np.float32) / 255),
    "npy": (".npy", lambda: _image(24, 40, 6, 4)),
    "exr": (".exr", lambda: _image(24, 40, 7).astype(np.float32) / 255),
}


@pytest.mark.parametrize("case", sorted(IO_CASES))
def test_image_files_round_trip_as_the_jax_package(tmp_path, case):
    """save_image writes the JAX package's bytes; load_image reads them
    (and the JAX package's own file) back into equal arrays."""
    suffix, make = IO_CASES[case]
    img = make()
    ours, theirs = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
    tio.save_image(ours, img)
    jio.save_image(theirs, img)
    assert ours.read_bytes() == theirs.read_bytes()
    assert read_mapped(str(ours)) == jread_mapped(str(theirs))
    got = tio.load_image(ours)
    np.testing.assert_array_equal(got, jio.load_image(theirs))
    if suffix != ".exr":  # EXR keeps half floats
        np.testing.assert_array_equal(got.reshape(img.shape), img)


def test_load_image_of_a_jxl_takes_the_device(tmp_path):
    """A .jxl input decodes on the given device: None is the JAX
    package's host decode exactly, "cpu" (the twins) within 1 u8 step."""
    img = _image(64, 72, 8)
    path = tmp_path / "a.jxl"
    path.write_bytes(tcs.encode_lossy(img, effort=3, device=None))
    ref = jio.load_image(path)
    np.testing.assert_array_equal(tio.load_image(path, device=None), ref)
    _near(tio.load_image(path, device="cpu"), ref)


def test_load_image_of_a_jxl_asks_for_the_card_by_default(tmp_path, no_card):
    path = tmp_path / "a.jxl"
    path.write_bytes(tcs.encode_lossy(_image(32, 32, 9), effort=3,
                                      device=None))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tio.load_image(path)


# ---------------------------------------------------------------- metrics
@pytest.mark.parametrize("kind", ["noise", "blur", "rgba", "u16"])
def test_ssimulacra2_agrees(kind):
    rng = np.random.default_rng(10)
    img = _image(72, 88, 11, 4 if kind == "rgba" else 3)
    f = img.astype(float)
    if kind == "blur":
        dist = (np.roll(f, 1, 0) + np.roll(f, -1, 0) + np.roll(f, 1, 1)
                + np.roll(f, -1, 1) + f) / 5
    else:
        dist = f + rng.normal(0, 8, f.shape)
    dist = np.clip(dist, 0, 255).astype(np.uint8)
    if kind == "u16":
        img, dist = img.astype(np.uint16) * 257, dist.astype(np.uint16) * 257
    got = tmetrics.ssimulacra2(img, dist)
    assert abs(got - jss2(img, dist)) <= 1e-9
    assert got < 100.0


def test_metrics_exports_agree():
    """metrics/__init__ exports what the JAX package's does, with equal
    values."""
    from libjxl_tpu import metrics as jmetrics

    a = _image(48, 64, 12)
    b = np.clip(a.astype(int) + 5, 0, 255).astype(np.uint8)
    for name in ("compute_psnr", "butteraugli_distance", "msssim_xyb",
                 "ssimulacra2"):
        got = getattr(tmetrics, name)(a, b)
        assert abs(got - getattr(jmetrics, name)(a, b)) <= 1e-9, name


def test_save_heatmap_equals_the_jax_package(tmp_path):
    pytest.importorskip("PIL.Image")
    from libjxl_tpu.api import stats as jstats

    vals = np.random.default_rng(13).uniform(0, 3, (9, 11))
    tstats.save_heatmap(vals, str(tmp_path / "t.png"), scale=4)
    jstats.save_heatmap(vals, str(tmp_path / "j.png"), scale=4)
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()


# ---------------------------------------------------------------- Decoder
def _drive(dec, data, chunks):
    """Feed `data` in `chunks` pieces; process after each until the
    decoder asks for more or ends. Returns the event sequence."""
    events = []
    step = -(-len(data) // chunks)
    for k in range(0, len(data), step):
        dec.set_input(data[k:k + step])
        while True:
            ev = dec.process()
            events.append(ev)
            if ev in ("need_more_input", "full_image", "success"):
                break
        if events[-1] != "need_more_input":
            break
    return events


def _blend_animation(frames, device):
    """A lossy animation whose second frame blends onto the first (kAdd
    from reference slot 1, where the first frame is saved): its frames
    are not independent, so api/decoder.Decoder decodes it whole through
    codestream.decode on its device. Written frame by frame as
    codestream.encode_animation writes its kReplace frames."""
    from libjxl_tpu_torch.api.codestream import write_codestream_header
    from libjxl_tpu_torch.io.bits import BitWriter
    from libjxl_tpu_torch.io.frame_header import (BLEND_ADD, CT_XYB,
                                                  ENC_VARDCT, FT_REGULAR,
                                                  FrameHeader)
    from libjxl_tpu_torch.io.headers import CodecMetadata, SizeHeader
    from libjxl_tpu_torch.ops.xyb import srgb_to_linear
    from libjxl_tpu_torch.vardct.frame import encode_vardct_frame

    h, w = frames[0].shape[:2]
    meta = CodecMetadata()
    meta.size = SizeHeader().set(w, h)
    meta.m.all_default = False
    meta.m.have_animation = True
    writer = BitWriter()
    write_codestream_header(writer, meta)
    for i, frame in enumerate(frames):
        fh = FrameHeader(meta)
        fh.all_default = False
        fh.frame_type = FT_REGULAR
        fh.encoding = ENC_VARDCT
        fh.color_transform = CT_XYB
        fh.flags = 0
        fh.is_last = i == len(frames) - 1
        fh.animation_frame.nonserialized_metadata = meta
        fh.animation_frame.duration = 1
        if i == 0:
            fh.save_as_reference = 1
        else:
            fh.blending_info.mode = BLEND_ADD
            fh.blending_info.source = 1
        fh.loop_filter.all_default = False
        fh.loop_filter.gab = True
        fh.loop_filter.epf_iters = 2
        rgb = np.moveaxis(srgb_to_linear(frame.astype(np.float64) / 255.0),
                          -1, 0)
        encode_vardct_frame(writer, rgb, fh, distance=1.0, device=device)
        writer.zero_pad_to_byte()
    return writer.get_bytes()


@pytest.fixture(scope="module")
def streams():
    """The Decoder's routes: a multi-group VarDCT still (per-section
    incremental, host render), a lossless multi-group still (per-group
    incremental), a progressive VarDCT still and an animation whose
    second frame blends onto the first (both whole-stream, through
    codestream.decode on the decoder's device), all from the port's host
    encoder."""
    img = _image(264, 320, 14)
    return {
        "vardct": tcs.encode_lossy(img, effort=3, device=None),
        "lossless": tcs.encode_lossless(img),
        "progressive": tcs.encode_lossy(img, effort=3, progressive=2,
                                        device=None),
        "blended": _blend_animation(
            [_image(256, 264, 15), _image(256, 264, 16)], device=None),
    }


@pytest.mark.parametrize("device", [None, "cpu"], ids=["host", "twins"])
@pytest.mark.parametrize("name", ["vardct", "lossless", "progressive",
                                  "blended"])
def test_decoder_events_and_image_on_chunked_input(streams, name, device):
    """The same event sequence as the JAX Decoder on 4 chunks; the image
    equal on the host routes, within 1 u8 step on the twins."""
    data = streams[name]
    ref = jdec.Decoder()
    want = _drive(ref, data, 4)
    dec = tdec.Decoder(device=device)
    assert _drive(dec, data, 4) == want
    assert want[-1] == "full_image"
    if device is None or name in ("vardct", "lossless"):
        np.testing.assert_array_equal(dec.image, ref.image)
    else:
        _near(dec.image, ref.image)
    assert dec.process() == ref.process() == "success"


def test_decoder_flush_equals_the_jax_package(streams):
    """flush_image of a stream cut after its DC groups (host render on
    both sides)."""
    data = streams["vardct"]
    for frac in (0.6, 0.85):
        ref, dec = jdec.Decoder(), tdec.Decoder(device=None)
        for d in (ref, dec):
            d.set_input(data[:int(len(data) * frac)])
            while d.process() not in ("need_more_input", "full_image",
                                      "success"):
                pass
        got = dec.flush_image()
        assert got is not None
        np.testing.assert_array_equal(got, ref.flush_image())


@pytest.mark.parametrize("device", [None, "cpu"], ids=["host", "twins"])
def test_decoder_truncation_raises_jxl_error(device):
    """A closed truncated stream raises JXLError (a RuntimeError, what a
    device failure raises, would pass through), like the JAX Decoder."""
    data = tcs.encode_lossy(_image(128, 136, 17), effort=3, device=None)
    for cut in range(1, len(data) - 1, 211):
        ref, dec = jdec.Decoder(), tdec.Decoder(device=device)
        for d, err in ((ref, JJXLError), (dec, JXLError)):
            d.set_input(data[:cut])
            d.close_input()
            with pytest.raises(err):
                while d.process() not in ("full_image", "success"):
                    pass


def test_decoder_whole_stream_route_asks_for_the_card_by_default(streams,
                                                                no_card):
    dec = tdec.Decoder()
    dec.set_input(streams["blended"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        while dec.process() not in ("need_more_input", "full_image"):
            pass


def test_decoder_jpeg_reconstruction_event():
    jpg = encode_jpegli(_image(64, 80, 18), distance=1.0, subsampling="420")
    data = recompress_jpeg_vardct(jpg)
    dec = tdec.Decoder(events=(tdec.JPEG_RECONSTRUCTION, tdec.BASIC_INFO),
                       device=None)
    dec.set_input(data)
    assert dec.process() == tdec.JPEG_RECONSTRUCTION
    assert dec.reconstruct_jpeg() == jpg
    assert dec.process() == tdec.BASIC_INFO


# ---------------------------------------------------------------- Encoder
ENCODER_CASES = {
    "e3": {"effort": 3},
    "e5-filters": {"effort": 5, "epf": 1, "gaborish": 0},
    "e3-progressive-container": {"effort": 3, "progressive_ac": 1,
                                 "container": True},
    "lossless": {"lossless": True},
    "animation": {"effort": 3, "frames": 2},
}


def _encode_with(mod, case, **kw):
    """The case's frames through an Encoder of `mod` (either package)."""
    opts = dict(ENCODER_CASES[case])
    enc = mod.Encoder(**kw)
    if opts.pop("container", False):
        enc.use_container = True
    fs = enc.frame_settings()
    lossless = opts.pop("lossless", False)
    frames = opts.pop("frames", 1)
    names = {"effort": mod.SETTING_EFFORT, "epf": mod.SETTING_EPF,
             "gaborish": mod.SETTING_GABORISH,
             "progressive_ac": mod.SETTING_PROGRESSIVE_AC}
    for key, value in opts.items():
        fs.set_option(names[key], value)
    fs.set_distance(0.0 if lossless else 1.5)
    for i in range(frames):
        enc.add_image_frame(fs, _image(96, 112, 19 + i))
    return enc.process_output()


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_encoder_on_the_host_equals_the_jax_encoder(case):
    assert _encode_with(tenc, case, device=None) == _encode_with(jenc, case)


@pytest.mark.parametrize("case", ["e3", "e5-filters", "animation"])
def test_encoder_on_the_twins_equals_the_ports_own_entries(case):
    """Encoder(device="cpu") gives encode_lossy(device="cpu")'s bytes
    (encode_animation's for two frames)."""
    got = _encode_with(tenc, case, device="cpu")
    if case == "animation":
        want = tcs.encode_animation([_image(96, 112, 19),
                                     _image(96, 112, 20)], lossless=False,
                                    distance=1.5, device="cpu")
    else:
        kw = {"e3": {}, "e5-filters": {"epf": 1, "gaborish": False}}[case]
        want = tcs.encode_lossy(_image(96, 112, 19), distance=1.5,
                                effort=ENCODER_CASES[case]["effort"],
                                device="cpu", **kw)
    assert got == want


def test_encoder_jpeg_frame_equals_the_jax_encoder():
    jpg = encode_jpegli(_image(64, 80, 21), distance=1.0)
    outs = []
    for mod, kw in ((tenc, {"device": None}), (jenc, {})):
        enc = mod.Encoder(**kw)
        enc.add_jpeg_frame(enc.frame_settings(), jpg)
        outs.append(enc.process_output())
    assert outs[0] == outs[1]


def test_encoder_asks_for_the_card_by_default(no_card):
    enc = tenc.Encoder()
    enc.add_image_frame(enc.frame_settings(), _image(32, 32, 22))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        enc.process_output()
