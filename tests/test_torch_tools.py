"""The port's command-line tools (libjxl_tpu_torch/tools: cjxl, djxl,
jxlinfo, benchmark) against the JAX package's, through main(argv) on
seeded inputs at most 256x256.

Tolerances (ROADMAP.md, "How checked against works"): --host gives the JAX
tools' output files and standard output byte for byte (benchmark's rows
but for their timings); --device cpu, the kernels' plain twins, gives a
decode within 1 u8 step of the host decode and the bytes of the port's
own encode entries on the same device; JPEG recompression gives the JAX
package's bytes and reconstruction the original JPEG exactly. The JAX
tools run on CPU-JAX, where their accelerator probe picks the host routes.
"""

import contextlib
import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from libjxl_tpu.tools import benchmark as jbench
from libjxl_tpu.tools import cjxl as jcjxl
from libjxl_tpu.tools import djxl as jdjxl
from libjxl_tpu.tools import jxlinfo as jinfo
from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.extras.io import load_image, save_image
from libjxl_tpu_torch.jpegli import encode_jpegli
from libjxl_tpu_torch.tools import benchmark as tbench
from libjxl_tpu_torch.tools import cjxl as tcjxl
from libjxl_tpu_torch.tools import djxl as tdjxl
from libjxl_tpu_torch.tools import jxlinfo as tinfo

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFORMANCE = ROOT / "tests" / "data" / "conformance"
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


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (120 + 60 * np.sin(xx * 0.03) + 50 * np.cos(yy * 0.02 + 1)
           + 20 * np.sin((xx + yy) * 0.1) + rng.normal(0, 5, (h, w)))
    rgb = np.stack([img, img * 0.9 + 10, img * 1.1 - 12], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def run(tool, argv):
    """(exit code, standard output) of tool.main(argv)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main([str(a) for a in argv])
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A photo as PPM, a small one for the encodes on the twins (whose e7
    diffmap is slow on a busy CPU), a 4:2:0 JPEG of the photo, an EXIF
    blob, and streams made by the port's host encoder: d1/e3 (two AC
    groups), lossless, a progressive (whole-stream) one, the JPEG's VarDCT
    recompression, and the e3 stream cut at 70%."""
    d = tmp_path_factory.mktemp("tools")
    img = _photo(200, 264, 31)
    save_image(d / "in.ppm", img)
    save_image(d / "small.ppm", _photo(96, 112, 30))
    jpg = encode_jpegli(img, distance=1.0, subsampling="420")
    (d / "in.jpg").write_bytes(jpg)
    (d / "exif.bin").write_bytes(b"Exif\0\0MM\0*" + bytes(16))
    e3 = tcs.encode_lossy(img, effort=3, device=None)
    (d / "e3.jxl").write_bytes(e3)
    (d / "cut.jxl").write_bytes(e3[:int(len(e3) * 0.7)])
    (d / "lossless.jxl").write_bytes(tcs.encode_lossless(img[:96, :120]))
    (d / "progressive.jxl").write_bytes(
        tcs.encode_lossy(img, effort=3, progressive=2, device=None))
    from libjxl_tpu_torch.jpeg.recompress import recompress_jpeg_vardct

    (d / "jbrd.jxl").write_bytes(recompress_jpeg_vardct(jpg))
    return d, img


# ------------------------------------------------------------------ cjxl
CJXL_CASES = {
    "e3": ["-e", "3"],
    "e7": ["-e", "7"],
    "e3-progressive": ["-e", "3", "-p", "2"],
    "q90-container-exif": ["-q", "90", "--container", "--exif",
                           "{d}/exif.bin"],
    "lossless-e7": ["-d", "0", "-e", "7"],  # the LZ77 match search
    "jpeg": [],
    "jpeg-tokens": ["--jpeg_transcode", "tokens"],
}


@pytest.mark.parametrize("case", sorted(CJXL_CASES))
def test_cjxl_on_the_host_equals_the_jax_cjxl(files, case):
    d, _ = files
    src = d / ("in.jpg" if case.startswith("jpeg") else "in.ppm")
    args = [a.format(d=d) for a in CJXL_CASES[case]]
    got = run(tcjxl, [src, d / f"t-{case}.jxl", *args, "--host"])
    assert got == run(jcjxl, [src, d / f"j-{case}.jxl", *args])
    assert got[0] == 0
    assert (d / f"t-{case}.jxl").read_bytes() == \
        (d / f"j-{case}.jxl").read_bytes()


def test_cjxl_recompressed_jpeg_reconstructs_through_djxl(files):
    """cjxl in.jpg out.jxl, then djxl out.jxl out.jpg: the original bytes,
    on the default device too (reconstruction is host work)."""
    d, _ = files
    assert run(tcjxl, [d / "in.jpg", d / "r.jxl"]) == (0, "")
    for extra in ([], ["--host"]):
        assert run(tdjxl, [d / "r.jxl", d / "r.jpg", *extra]) == (0, "")
        assert (d / "r.jpg").read_bytes() == (d / "in.jpg").read_bytes()
    assert run(tdjxl, [CONFORMANCE / "jpeg_recon.jxl", d / "c.jpg"]) \
        == (0, "")
    assert (d / "c.jpg").read_bytes() == \
        (CONFORMANCE / "jpeg_recon.jpg").read_bytes()


@pytest.mark.parametrize("effort", [3, 7])
def test_cjxl_on_the_twins_equals_encode_lossy(files, effort):
    d, _ = files
    out = d / f"cpu-e{effort}.jxl"
    assert run(tcjxl, [d / "small.ppm", out, "-e", effort, "--device",
                       "cpu"]) == (0, "")
    assert out.read_bytes() == tcs.encode_lossy(
        load_image(d / "small.ppm"), distance=1.0, effort=effort,
        device="cpu")


def test_cjxl_streaming_on_the_twins_equals_the_streaming_entry(files):
    d, _ = files
    out = d / "stream.jxl"
    assert run(tcjxl, [d / "small.ppm", out, "--streaming", "--device",
                       "cpu"]) == (0, "")
    assert out.read_bytes() == tcs.encode_lossy_streaming(
        load_image(d / "small.ppm"), distance=1.0, device="cpu")


def test_cjxl_debug_heatmaps(files):
    """--debug_heatmaps (api/stats.save_heatmap) writes the JAX cjxl's
    three PNGs on the host, and the same three files on the twins."""
    pytest.importorskip("PIL.Image")
    d, _ = files
    src = d / "small.ppm"
    run(jcjxl, [src, d / "hj.jxl", "-e", "5", "--debug_heatmaps", d / "hj"])
    assert run(tcjxl, [src, d / "ht.jxl", "-e", "5", "--host",
                       "--debug_heatmaps", d / "ht"]) == (0, "")
    assert run(tcjxl, [src, d / "hc.jxl", "-e", "5", "--device", "cpu",
                       "--debug_heatmaps", d / "hc"]) == (0, "")
    for part in ("quant", "sharp", "acs"):
        want = (d / f"hj_{part}.png").read_bytes()
        assert (d / f"ht_{part}.png").read_bytes() == want
        assert load_image(d / f"hc_{part}.png").shape == \
            load_image(d / f"hj_{part}.png").shape


# ------------------------------------------------------------------ djxl
DJXL_CASES = {
    "e3": ("e3.jxl", "ppm", []),
    "lossless": ("lossless.jxl", "ppm", []),
    "progressive": ("progressive.jxl", "ppm", []),
    "low-memory": ("e3.jxl", "ppm", ["--low_memory"]),
    "dc-preview": ("e3.jxl", "ppm", ["--downsampling", "8"]),
    "downsample-2": ("e3.jxl", "ppm", ["--downsampling", "2"]),
    "float32": ("e3.jxl", "npy", ["--pixel_format", "float32"]),
    "partial": ("cut.jxl", "ppm", ["--allow_partial_files"]),
    "jbrd-jpg": ("jbrd.jxl", "jpg", []),
    "jbrd-pixels": ("jbrd.jxl", "ppm", []),
}


@pytest.mark.parametrize("case", sorted(DJXL_CASES))
def test_djxl_on_the_host_equals_the_jax_djxl(files, case):
    d, _ = files
    name, ext, args = DJXL_CASES[case]
    got = run(tdjxl, [d / name, d / f"t-{case}.{ext}", *args, "--host"])
    assert got == run(jdjxl, [d / name, d / f"j-{case}.{ext}", *args])
    assert got[0] == 0
    assert (d / f"t-{case}.{ext}").read_bytes() == \
        (d / f"j-{case}.{ext}").read_bytes()


@pytest.mark.parametrize("case", ["e3", "progressive", "low-memory",
                                  "downsample-2", "partial", "jbrd-pixels"])
def test_djxl_on_the_twins_is_within_one_step(files, case, capsys):
    """--device cpu renders VarDCT frames on the twins (the path -v
    reports): within 1 u8 step of the JAX djxl's output, except a
    recompressed JPEG, whose YCbCr frame renders on the device where the
    host route decodes the reconstructed JPEG: that one is held to the
    plain decode of the JPEG's coefficients
    (tests/reference/jpeg_transcode_ref.py)."""
    d, _ = files
    name, ext, args = DJXL_CASES[case]
    out = d / f"c-{case}.{ext}"
    assert run(tdjxl, [d / name, out, *args, "--device", "cpu",
                       "-v"]) == (0, "")
    said = capsys.readouterr().err
    if case == "low-memory":
        assert "render path: low-memory on cpu" in said
    elif case != "partial":
        assert "render path: device:" in said, said
    if case == "jbrd-pixels":
        from libjxl_tpu_torch.jpeg.data import parse_jpeg
        from reference import jpeg_transcode_ref

        ref = jpeg_transcode_ref.decode_parsed(
            parse_jpeg((d / "in.jpg").read_bytes()))
    else:
        run(jdjxl, [d / name, d / f"j-{case}.{ext}", *args])
        ref = load_image(d / f"j-{case}.{ext}")
    got = load_image(out)
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= U8_BOUND


def test_djxl_and_cjxl_ask_for_the_card_by_default(files, no_card):
    d, _ = files
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdjxl.main([str(d / "e3.jxl"), str(d / "x.ppm")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcjxl.main([str(d / "in.ppm"), str(d / "x.jxl"), "-e", "3"])


def test_djxl_allow_partial_files_lets_a_device_error_through(files, no_card):
    """--allow_partial_files catches what a truncated stream raises, not a
    device error: a whole stream that takes the Decoder's whole-stream
    route asks for the card and raises without one (the JAX djxl catches
    any exception there)."""
    d, _ = files
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdjxl.main([str(d / "progressive.jxl"), str(d / "x.ppm"),
                    "--allow_partial_files"])


# --------------------------------------------------------------- jxlinfo
@pytest.mark.parametrize("name", ["e3.jxl", "lossless.jxl", "jbrd.jxl",
                                  "q90-container-exif", "corpus"])
def test_jxlinfo_prints_what_the_jax_jxlinfo_prints(files, name):
    d, _ = files
    if name == "corpus":
        paths = sorted(CONFORMANCE.glob("*.jxl"))
    elif name.endswith(".jxl"):
        paths = [d / name]
    else:
        run(jcjxl, [d / "in.ppm", d / "info.jxl", "-q", "90", "--container",
                    "--exif", d / "exif.bin"])
        paths = [d / "info.jxl"]
    for path in paths:
        got = run(tinfo, [path, "-v"])
        assert got == run(jinfo, [path, "-v"])
        assert got[0] == 0 and "dimensions:" in got[1]


# ------------------------------------------------------------- benchmark
TIMINGS = ("enc_mps", "dec_mps")


def _rows(stdout):
    rows = [json.loads(line) for line in stdout.splitlines()]
    for row in rows:
        for key in TIMINGS:
            assert row.pop(key) > 0
    return rows


def test_benchmark_rows_on_the_host_equal_the_jax_benchmark(files):
    d, _ = files
    small = d / "small.ppm"
    save_image(small, _photo(64, 72, 32))
    codec = ["--codec", "d1.0,m,jpegli:d1.0:420"]
    rc, out = run(tbench, [small, *codec, "--host"])
    jrc, jout = run(jbench, [small, *codec])
    assert rc == jrc == 0
    assert _rows(out) == _rows(jout)


def test_benchmark_on_the_twins_reports_the_devices_stream(files):
    d, _ = files
    small = d / "small2.ppm"
    img = _photo(64, 72, 33)
    save_image(small, img)
    rc, out = run(tbench, [small, "--codec", "d1.0", "--device", "cpu"])
    (row,) = _rows(out)
    data = tcs.encode_lossy(img, distance=1.0, device="cpu")
    assert rc == 0 and row["config"] == "d1.0"
    assert row["bpp"] == round(len(data) * 8 / img[:, :, 0].size, 4)
    assert row["psnr"] > 30


@pytest.mark.parametrize("tool", ["cjxl", "djxl", "jxlinfo", "benchmark"])
def test_each_tool_runs_as_a_module(tool):
    res = subprocess.run([sys.executable, "-m",
                          f"libjxl_tpu_torch.tools.{tool}", "--help"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "usage:" in res.stdout
