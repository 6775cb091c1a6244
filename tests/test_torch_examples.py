"""The port's examples (libjxl_tpu_torch/examples: decode_oneshot,
decode_exif_metadata, encode_oneshot, decode_progressive) against the
scripts of examples/, which drive the JAX package, on seeded inputs at
most 256x256.

Tolerances (ROADMAP.md, "How checked against works"): --host gives the
scripts' output files and standard output byte for byte; --device cpu,
the kernels' plain twins, decodes within 1 u8 step of the host decode and
encodes the bytes of the port's encode_lossy on the same device. The
scripts run on CPU-JAX, where the accelerator probe picks the host routes.
"""

import contextlib
import importlib.util
import inspect
import io
import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.examples import decode_exif_metadata as texif
from libjxl_tpu_torch.examples import decode_oneshot as tdec
from libjxl_tpu_torch.examples import decode_progressive as tprog
from libjxl_tpu_torch.examples import encode_oneshot as tenc
from libjxl_tpu_torch.extras.io import load_image, save_image
from libjxl_tpu_torch.io.container import extract_codestream, \
    wrap_codestream

ROOT = pathlib.Path(__file__).resolve().parents[1]
U8_BOUND = 1  # u8 steps from the host decode (tests/test_decode_batch.py)
EXAMPLES = ("decode_oneshot", "decode_exif_metadata", "encode_oneshot",
            "decode_progressive")


def _script(name):
    """examples/<name>.py, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The twins' torch ops on one thread: tier-1 runs six test processes
    on the machine's cores."""
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


def _exif(orientation):
    return (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHI", 0x112, 3, 1)
            + struct.pack("<HH", orientation, 0) + struct.pack("<I", 0))


def run(argv, port=None, script=None, monkeypatch=None):
    """(exit code, standard output) of the port's main(argv) or of the
    script's main under sys.argv = [script, *argv]."""
    out = io.StringIO()
    argv = [str(a) for a in argv]
    with contextlib.redirect_stdout(out):
        if port is not None:
            rc = port.main(argv)
        else:
            monkeypatch.setattr(sys, "argv", [script.__file__, *argv])
            # decode_exif_metadata's main takes argv, the others read it
            takes_argv = bool(inspect.signature(script.main).parameters)
            rc = script.main(sys.argv) if takes_argv else script.main()
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 96x112 photo as PPM; its d1/e3 stream by the port's host encoder,
    bare and in a container with an Exif box (orientation 6); a
    3-pass progressive e3 stream."""
    d = tmp_path_factory.mktemp("examples")
    img = _photo(96, 112, 51)
    save_image(d / "photo.ppm", img)
    e3 = tcs.encode_lossy(img, effort=3, device=None)
    (d / "e3.jxl").write_bytes(e3)
    (d / "exif.jxl").write_bytes(wrap_codestream(
        e3, exif=_exif(6), compress_boxes=False))
    (d / "progressive.jxl").write_bytes(tcs.encode_lossy(
        img, effort=3, progressive=3, device=None))
    return d, img


def _same_files(a, b):
    assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()


# -------------------------------------------------------- decode_oneshot
@pytest.mark.parametrize("src", ["e3.jxl", "exif.jxl"])
def test_decode_oneshot_on_the_host_equals_the_script(files, src,
                                                      monkeypatch):
    d, _ = files
    got = run([d / src, d / "t-dec.ppm", "--host"], port=tdec)
    assert got == run([d / src, d / "j-dec.ppm"],
                      script=_script("decode_oneshot"),
                      monkeypatch=monkeypatch)
    assert got == (0, "decoded 112x96\n")
    _same_files(d / "t-dec.ppm", d / "j-dec.ppm")


def test_decode_oneshot_on_the_twins_is_within_one_step(files):
    d, _ = files
    assert run([d / "e3.jxl", d / "c-dec.ppm", "--device", "cpu"],
               port=tdec) == (0, "decoded 112x96\n")
    got = load_image(d / "c-dec.ppm").astype(int)
    ref = tcs.decode((d / "e3.jxl").read_bytes(), device=None)[0]
    assert np.abs(got - ref.astype(int)).max() <= U8_BOUND


# -------------------------------------------------- decode_exif_metadata
@pytest.mark.parametrize("src", ["exif.jxl", "e3.jxl"])
def test_decode_exif_metadata_on_the_host_equals_the_script(files, src,
                                                            monkeypatch):
    d, _ = files
    got = run([d / src, d / "t-exif.ppm", "--host"], port=texif)
    assert got == run([d / src, d / "j-exif.ppm"],
                      script=_script("decode_exif_metadata"),
                      monkeypatch=monkeypatch)
    assert got[0] == 0
    if src == "exif.jxl":
        assert "orientation=6" in got[1] and "after reset: 1" in got[1]
    _same_files(d / "t-exif.ppm", d / "j-exif.ppm")


def test_decode_exif_metadata_on_the_twins_is_within_one_step(files):
    d, _ = files
    rc, out = run([d / "exif.jxl", d / "c-exif.ppm", "--device", "cpu"],
                  port=texif)
    assert rc == 0 and "decoded 112x96 image" in out
    got = load_image(d / "c-exif.ppm").astype(int)
    ref = load_image(d / "e3.jxl", device=None).astype(int)
    assert np.abs(got - ref).max() <= U8_BOUND


# -------------------------------------------------------- encode_oneshot
@pytest.mark.parametrize("case", [("photo.ppm", []), ("photo.ppm", ["2.5"]),
                                  ("photo.ppm", ["0"]), ("e3.jxl", [])],
                         ids=["d1", "d2.5", "lossless", "jxl-input"])
def test_encode_oneshot_on_the_host_equals_the_script(files, case,
                                                      monkeypatch):
    d, _ = files
    src, extra = case
    got = run([d / src, d / "t-enc.jxl", *extra, "--host"], port=tenc)
    assert got == run([d / src, d / "j-enc.jxl", *extra],
                      script=_script("encode_oneshot"),
                      monkeypatch=monkeypatch)
    assert got[0] == 0 and got[1].startswith("wrote ")
    _same_files(d / "t-enc.jxl", d / "j-enc.jxl")


@pytest.mark.parametrize("src", ["photo.ppm", "e3.jxl"])
def test_encode_oneshot_on_the_twins_encodes_there(files, src):
    """The default e5 encode on the twins (tile costs) of the input, a .jxl
    input decoded on the twins too."""
    d, _ = files
    out = d / "c-enc.jxl"
    assert run([d / src, out, "--device", "cpu"], port=tenc)[0] == 0
    pixels = load_image(d / src, device="cpu")
    want = tcs.encode_lossy(pixels, distance=1.0, icc=None, device="cpu")
    assert extract_codestream(out.read_bytes()) == want


# ---------------------------------------------------- decode_progressive
def test_decode_progressive_equals_the_script(files, monkeypatch):
    """Host code on either side: one PNG a pass, equal to the script's."""
    pytest.importorskip("PIL.Image")
    d, _ = files
    got = run([d / "progressive.jxl", d / "t"], port=tprog)
    rc, out = run([d / "progressive.jxl", d / "j"],
                  script=_script("decode_progressive"),
                  monkeypatch=monkeypatch)
    assert got == (rc, out.replace(str(d / "j"), str(d / "t")))
    assert rc == 0 and out.count(" -> ") >= 2
    for k in range(1, out.count(" -> ") + 1):
        _same_files(d / f"t_pass{k}.png", d / f"j_pass{k}.png")


# ---------------------------------------------------------- card default
@pytest.mark.parametrize("example,argv", [
    (tdec, ["{d}/e3.jxl", "{d}/x.ppm"]),
    (texif, ["{d}/exif.jxl"]),
    (tenc, ["{d}/photo.ppm", "{d}/x.jxl"]),
    (tenc, ["{d}/e3.jxl", "{d}/x.jxl", "0"]),
], ids=["decode_oneshot", "decode_exif_metadata", "encode_oneshot",
        "encode_oneshot-jxl-lossless"])
def test_each_example_asks_for_the_card_by_default(files, example, argv,
                                                   no_card):
    d, _ = files
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example.main([a.format(d=d) for a in argv])


def test_encode_oneshot_lossless_needs_no_card(files):
    d, img = files
    assert run([d / "photo.ppm", d / "ll.jxl", "0"], port=tenc)[0] == 0
    data = extract_codestream((d / "ll.jxl").read_bytes())
    assert np.array_equal(tcs.decode(data, device=None)[0], img)


# -------------------------------------------------------------- modules
_HELP_ALL = """
import contextlib, io, runpy, sys
for name in sys.argv[1:]:
    sys.argv = [name, "--help"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_module(f"libjxl_tpu_torch.examples.{name}",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, (name, e.code)
    print(f"=={name}== " + out.getvalue().replace("\\n", " "))
"""


@pytest.fixture(scope="module")
def helps():
    """Each example's --help as `python -m` gives it, from one process."""
    res = subprocess.run([sys.executable, "-c", _HELP_ALL, *EXAMPLES],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "COLUMNS": "100"})
    assert res.returncode == 0, res.stderr[-3000:]
    return {line.split("==")[1]: line for line in res.stdout.splitlines()
            if line.startswith("==")}


@pytest.mark.parametrize("name", EXAMPLES)
def test_each_example_runs_as_a_module(helps, name):
    assert "usage:" in helps[name]
    assert ("--device" in helps[name]) == (name != "decode_progressive")
