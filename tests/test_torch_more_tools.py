"""The port's remaining host tools (libjxl_tpu_torch/tools: decode_and_encode,
jxl_from_tree, cjpegli, djpegli, butteraugli_main, ssimulacra2_main, hdr,
icc_simplify, optimizer, rd_measure; io/icc_analyze, extras/gain_map,
extras/oracle) and cjxl's .jxl input against the JAX package's, through
main(argv) on seeded inputs at most 256x256.

Tolerances (ROADMAP.md, "How checked against works"): --host gives the JAX
tools' output files and standard output byte for byte; --device cpu, the
kernels' plain twins, decodes a .jxl input within 1 u8 step of the host
decode, and the tool's output is then what the same tool gives for the
twins' pixels. Every tool that decodes a .jxl asks for the card by default
and raises without one. The JAX tools run on CPU-JAX, where their
accelerator probe picks the host routes.
"""

import contextlib
import io
import os
import pathlib
import stat
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from libjxl_tpu.extras import gain_map as jgm
from libjxl_tpu.extras import oracle as joracle
from libjxl_tpu.io import icc_analyze as jicc
from libjxl_tpu.io.headers import ColorEncoding as JColorEncoding
from libjxl_tpu.tools import butteraugli_main as jba
from libjxl_tpu.tools import cjpegli as jcjpegli
from libjxl_tpu.tools import cjxl as jcjxl
from libjxl_tpu.tools import decode_and_encode as jdae
from libjxl_tpu.tools import djpegli as jdjpegli
from libjxl_tpu.tools import hdr as jhdr
from libjxl_tpu.tools import icc_simplify as jsimplify
from libjxl_tpu.tools import jxl_from_tree as jtree
from libjxl_tpu.tools import optimizer as jopt
from libjxl_tpu.tools import rd_measure as jrd
from libjxl_tpu.tools import ssimulacra2_main as js2
from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.extras import gain_map as tgm
from libjxl_tpu_torch.extras import oracle as toracle
from libjxl_tpu_torch.extras.io import load_image, save_image
from libjxl_tpu_torch.io import icc_analyze as ticc
from libjxl_tpu_torch.io.headers import ColorEncoding as TColorEncoding
from libjxl_tpu_torch.jpegli import encode_jpegli
from libjxl_tpu_torch.metrics import butteraugli_distance, ssimulacra2
from libjxl_tpu_torch.render.tone_map import pq_inv_eotf
from libjxl_tpu_torch.tools import butteraugli_main as tba
from libjxl_tpu_torch.tools import cjpegli as tcjpegli
from libjxl_tpu_torch.tools import cjxl as tcjxl
from libjxl_tpu_torch.tools import decode_and_encode as tdae
from libjxl_tpu_torch.tools import djpegli as tdjpegli
from libjxl_tpu_torch.tools import hdr as thdr
from libjxl_tpu_torch.tools import icc_simplify as tsimplify
from libjxl_tpu_torch.tools import jxl_from_tree as ttree
from libjxl_tpu_torch.tools import optimizer as topt
from libjxl_tpu_torch.tools import rd_measure as trd
from libjxl_tpu_torch.tools import ssimulacra2_main as ts2

ROOT = pathlib.Path(__file__).resolve().parents[1]
U8_BOUND = 1  # u8 steps from the host decode (tests/test_decode_batch.py)


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


def _srgb_icc():
    from PIL import ImageCms

    return ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()


def _cicp_icc(prim, trc):
    """A minimal profile: header and one cicp tag
    (tests/test_icc_tools.py:28)."""
    cicp = b"cicp" + b"\x00" * 4 + bytes([prim, trc, 0, 1])
    hdr = bytearray(132)
    hdr[16:20] = b"RGB "
    hdr[128:132] = struct.pack(">I", 1)
    return bytes(hdr[:132]) + b"cicp" + struct.pack(">II", 144, len(cicp)) \
        + cicp


def run(tool, argv):
    """(exit code, standard output) of tool.main(argv)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main([str(a) for a in argv])
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 96x112 photo as PPM, its d1/e3 stream made by the port's host
    encoder, a PNG tagged with an sRGB profile (and the profile alone), a
    PQ-coded PFM (tests/test_hdr_tools.py's) and an 8-bit JPEG of the
    photo."""
    d = tmp_path_factory.mktemp("more_tools")
    img = _photo(96, 112, 41)
    save_image(d / "photo.ppm", img)
    (d / "e3.jxl").write_bytes(tcs.encode_lossy(img, effort=3, device=None))
    save_image(d / "tagged.png", img[:16, :24], icc=_srgb_icc())
    (d / "srgb.icc").write_bytes(_srgb_icc())
    yy, xx = np.mgrid[0:32, 0:40]
    nits = 10 + 900.0 * (np.sin(xx / 9.0) * 0.5 + 0.5)[..., None] \
        * np.array([1.0, 0.8, 0.6])
    save_image(d / "pq.pfm", pq_inv_eotf(nits).astype(np.float32))
    (d / "photo.jpg").write_bytes(encode_jpegli(img, distance=1.0))
    return d, img


def _same_files(a, b):
    assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()


def _near_host(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= U8_BOUND


# ------------------------------------------------ cjxl's .jxl input (repair)
def test_cjxl_of_a_jxl_input_on_the_host_equals_the_jax_cjxl(files):
    """Before the repair, --host still decoded the input on the card."""
    d, _ = files
    got = run(tcjxl, [d / "e3.jxl", d / "t-cjxl.jxl", "--host"])
    assert got == run(jcjxl, [d / "e3.jxl", d / "j-cjxl.jxl"]) == (0, "")
    _same_files(d / "t-cjxl.jxl", d / "j-cjxl.jxl")


def test_cjxl_of_a_jxl_input_on_the_twins_decodes_and_encodes_there(files):
    d, _ = files
    out = d / "cpu-cjxl.jxl"
    assert run(tcjxl, [d / "e3.jxl", out, "--device", "cpu"]) == (0, "")
    pixels = load_image(d / "e3.jxl", device="cpu")
    _near_host(pixels, load_image(d / "e3.jxl", device=None))
    assert out.read_bytes() == tcs.encode_lossy(
        pixels, distance=1.0, effort=3, device="cpu")


def test_cjxl_of_a_jxl_input_asks_for_the_card_by_default(files, no_card):
    d, _ = files
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcjxl.main([str(d / "e3.jxl"), str(d / "x.jxl")])


# ----------------------------------------------------- decode_and_encode
DAE_CASES = {"jxl-ppm": ("e3.jxl", "ppm"), "jxl-npy": ("e3.jxl", "npy"),
             "jxl-jxl": ("e3.jxl", "jxl"), "ppm-jxl": ("photo.ppm", "jxl"),
             "gray-pgx": ("gray.ppm", "pgx")}


@pytest.mark.parametrize("case", sorted(DAE_CASES))
def test_decode_and_encode_on_the_host_equals_the_jax_tool(files, case):
    d, img = files
    src, ext = DAE_CASES[case]
    if ext == "pgx":  # PGX is grayscale
        save_image(d / "gray.ppm", img[:, :, :1].copy())
    got = run(tdae, [d / src, d / f"t-{case}.{ext}", "--host"])
    assert got == run(jdae, [d / src, d / f"j-{case}.{ext}"]) == (0, "")
    _same_files(d / f"t-{case}.{ext}", d / f"j-{case}.{ext}")


def test_decode_and_encode_on_the_twins_is_within_one_step(files):
    d, _ = files
    assert run(tdae, [d / "e3.jxl", d / "c-dae.ppm", "--device", "cpu"]) \
        == (0, "")
    run(jdae, [d / "e3.jxl", d / "j-dae.ppm"])
    _near_host(load_image(d / "c-dae.ppm"), load_image(d / "j-dae.ppm"))


# --------------------------------------------------------- jxl_from_tree
TREES = {
    "extras-apis": """
    RCT 6
    Width 128 Height 96 Bitdepth 8
    if c > 0
      - Set 7
      if x > 63
        - Set 255
        if y > 48
          - Gradient + 2
          - Set 0
    """,
    "weighted": """
    Width 40 Height 24
    if |N| > 3
      - Weighted - 1
      - AvgN+NW + 5
    """,
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_jxl_from_tree_on_the_host_equals_the_jax_tool(files, tree):
    d, _ = files
    (d / f"{tree}.txt").write_text(textwrap.dedent(TREES[tree]))
    rc, out = run(ttree, [d / f"{tree}.txt", d / f"t-{tree}.jxl",
                          d / f"t-{tree}.ppm", "--host"])
    got = (rc, out.replace(f"t-{tree}", f"j-{tree}"))
    assert got == run(jtree, [d / f"{tree}.txt", d / f"j-{tree}.jxl",
                              d / f"j-{tree}.ppm"])
    assert got[0] == 0 and "decoded to" in got[1]
    for ext in ("jxl", "ppm"):
        _same_files(d / f"t-{tree}.{ext}", d / f"j-{tree}.{ext}")


def test_jxl_from_tree_decode_takes_the_host_path_on_any_device(files):
    """A modular stream: the device decode records the host path and
    launches nothing; the twins' output is the host's."""
    d, _ = files
    (d / "tree.txt").write_text(textwrap.dedent(TREES["extras-apis"]))
    assert run(ttree, [d / "tree.txt", d / "c-tree.jxl", d / "c-tree.ppm",
                       "--device", "cpu"])[0] == 0
    info = {}
    img, _ = tcs.decode((d / "c-tree.jxl").read_bytes(), device="cpu",
                        decode_info=info)
    assert info["path"] == "host:modular"
    assert np.array_equal(load_image(d / "c-tree.ppm"), img)


def test_jxl_from_tree_asks_for_the_card_only_to_decode(files, no_card):
    d, _ = files
    (d / "tree.txt").write_text(textwrap.dedent(TREES["weighted"]))
    assert run(ttree, [d / "tree.txt", d / "n-tree.jxl"])[0] == 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttree.main([str(d / "tree.txt"), str(d / "n-tree.jxl"),
                    str(d / "n-tree.ppm")])


# ------------------------------------------------------ cjpegli / djpegli
CJPEGLI_CASES = {"default": [], "q90-420": ["-q", "90",
                                            "--chroma_subsampling", "420"],
                 "progressive-fixed": ["-p", "2", "--fixed_code"],
                 "std-noaq": ["--std_quant", "--noadaptive_quantization"]}


@pytest.mark.parametrize("src", ["photo.ppm", "e3.jxl"])
@pytest.mark.parametrize("case", sorted(CJPEGLI_CASES))
def test_cjpegli_on_the_host_equals_the_jax_cjpegli(files, case, src):
    d, _ = files
    args = CJPEGLI_CASES[case]
    name = f"{case}-{src.split('.')[1]}"
    got = run(tcjpegli, [d / src, d / f"t-{name}.jpg", *args, "--host"])
    assert got == run(jcjpegli, [d / src, d / f"j-{name}.jpg", *args]) \
        == (0, "")
    _same_files(d / f"t-{name}.jpg", d / f"j-{name}.jpg")


def test_cjpegli_of_a_jxl_on_the_twins_encodes_the_twins_pixels(files):
    d, _ = files
    assert run(tcjpegli, [d / "e3.jxl", d / "c.jpg", "--device", "cpu"]) \
        == (0, "")
    assert (d / "c.jpg").read_bytes() == encode_jpegli(
        load_image(d / "e3.jxl", device="cpu"), distance=None, quality=None,
        subsampling="444", std_tables=False, adaptive=True, optimize=True,
        progressive=0)


@pytest.mark.parametrize("bitdepth", [8, 16])
def test_djpegli_equals_the_jax_djpegli(files, bitdepth):
    d, _ = files
    args = [d / "photo.jpg", "--bitdepth", bitdepth]
    got = run(tdjpegli, [args[0], d / f"t-{bitdepth}.ppm", *args[1:]])
    assert got == run(jdjpegli, [args[0], d / f"j-{bitdepth}.ppm",
                                 *args[1:]]) == (0, "")
    _same_files(d / f"t-{bitdepth}.ppm", d / f"j-{bitdepth}.ppm")


# ------------------------------------------------------ the metric CLIs
METRIC_TOOLS = {
    "butteraugli": (tba, jba, lambda a, b: butteraugli_distance(
        a[:, :, :3], b[:, :, :3])),
    "ssimulacra2": (ts2, js2, lambda a, b: ssimulacra2(a, b, bg=0.5))}


@pytest.mark.parametrize("tool", sorted(METRIC_TOOLS))
def test_metric_cli_on_the_host_equals_the_jax_cli(files, tool):
    d, _ = files
    tmod, jmod, _ = METRIC_TOOLS[tool]
    for pair in (["photo.ppm", "e3.jxl"], ["e3.jxl", "photo.ppm"]):
        got = run(tmod, [*(d / p for p in pair), "--host"])
        assert got == run(jmod, [d / p for p in pair])
        assert got[0] == 0 and float(got[1]) > 0


@pytest.mark.parametrize("tool", sorted(METRIC_TOOLS))
def test_metric_cli_on_the_twins_scores_the_twins_pixels(files, tool):
    d, img = files
    tmod, _, metric = METRIC_TOOLS[tool]
    rc, out = run(tmod, [d / "photo.ppm", d / "e3.jxl", "--device", "cpu"])
    dist = load_image(d / "e3.jxl", device="cpu")
    assert rc == 0 and out == f"{metric(img, dist):.8f}\n"


# ------------------------------------------------------------------- hdr
HDR_CASES = {"tone_map": ["--source_nits", "4010", "--target_nits", "300"],
             "pq_to_hlg": ["--max_nits", "1000"], "hlg_to_pq": [],
             "render_hlg": ["--max_nits", "600"]}


@pytest.mark.parametrize("cmd", sorted(HDR_CASES))
@pytest.mark.parametrize("src", ["pq.pfm", "e3.jxl"])
def test_hdr_on_the_host_equals_the_jax_tool(files, cmd, src):
    d, _ = files
    ext = "npy" if src.endswith("jxl") else "pfm"
    name = f"{cmd}-{src.split('.')[1]}"
    args = HDR_CASES[cmd]
    got = run(thdr, [cmd, d / src, d / f"t-{name}.{ext}", *args, "--host"])
    assert got == run(jhdr, [cmd, d / src, d / f"j-{name}.{ext}", *args]) \
        == (0, "")
    _same_files(d / f"t-{name}.{ext}", d / f"j-{name}.{ext}")


def test_hdr_of_a_jxl_on_the_twins_maps_the_twins_pixels(files):
    d, _ = files
    save_image(d / "twins.ppm", load_image(d / "e3.jxl", device="cpu"))
    assert run(thdr, ["render_hlg", d / "e3.jxl", d / "c-hlg.npy",
                      "--device", "cpu"]) == (0, "")
    assert run(thdr, ["render_hlg", d / "twins.ppm", d / "p-hlg.npy"]) \
        == (0, "")
    _same_files(d / "c-hlg.npy", d / "p-hlg.npy")


# ---------------------------------------------------------- icc_simplify
@pytest.mark.parametrize("src", ["tagged.png", "srgb.icc", "e3.jxl"])
def test_icc_simplify_on_the_host_equals_the_jax_tool(files, src, capsys):
    """The tagged PNG is rewritten untagged; a .jxl input decodes (on the
    host here) and carries no profile."""
    d, _ = files
    out = [d / "t-simple.png"] if src == "tagged.png" else []
    got = run(tsimplify, [d / src, *out, "--host"])
    said = capsys.readouterr().err
    jout = [d / "j-simple.png"] if out else []
    assert got == run(jsimplify, [d / src, *jout])
    assert said == capsys.readouterr().err.replace("j-", "t-")
    assert got[0] == (1 if src == "e3.jxl" else 0)
    if out:
        _same_files(out[0], jout[0])
        from PIL import Image

        assert Image.open(out[0]).info.get("icc_profile") is None


@pytest.mark.parametrize("profile", ["srgb", "cicp-pq", "cicp-hlg-p3",
                                     "truncated"])
def test_analyze_icc_equals_the_jax_analysis(profile):
    icc = {"srgb": _srgb_icc, "cicp-pq": lambda: _cicp_icc(9, 16),
           "cicp-hlg-p3": lambda: _cicp_icc(12, 18),
           "truncated": lambda: b"\x00" * 40}[profile]()
    if profile == "truncated":
        with pytest.raises(Exception) as t:
            ticc.analyze_icc(icc)
        with pytest.raises(Exception) as j:
            jicc.analyze_icc(icc)
        assert type(t.value).__name__ == type(j.value).__name__ == \
            "JXLError" and str(t.value) == str(j.value)
        return
    assert ticc.analyze_icc(icc) == jicc.analyze_icc(icc)


# -------------------------------------------------------------- gain_map
def test_gain_map_bundle_equals_the_jax_bundle():
    stream = tcs.encode_lossy(_photo(64, 64, 5), distance=3.0, device=None)
    icc = b"\x00\x00\x02\x00" + bytes(range(256)) * 2
    alt = tgm.icc_profile_encode(icc)
    assert alt == jgm.icc_profile_encode(icc)
    assert tgm.icc_profile_decode(alt) == jgm.icc_profile_decode(alt) == icc
    blobs = []
    for gm, ce in ((tgm, TColorEncoding()), (jgm, JColorEncoding())):
        blobs.append(gm.write_gain_map_bundle(gm.GainMapBundle(
            jhgm_version=1, gain_map_metadata=b"xmp-meta",
            color_encoding=ce, alt_icc=alt, gain_map=stream)))
    assert blobs[0] == blobs[1]
    back = tgm.read_gain_map_bundle(blobs[0])
    assert (back.jhgm_version, back.gain_map_metadata, back.alt_icc,
            back.gain_map) == (1, b"xmp-meta", alt, stream)
    assert tcs.decode(back.gain_map, device=None)[0].shape == (64, 64, 3)


def test_a_truncated_gain_map_bundle_is_rejected_as_the_jax_one():
    blob = tgm.write_gain_map_bundle(tgm.GainMapBundle(
        gain_map_metadata=b"abc"))
    for cut in (0, 2, 5):
        with pytest.raises(Exception, match="truncated gain map bundle"):
            tgm.read_gain_map_bundle(blob[:cut])
        with pytest.raises(Exception, match="truncated gain map bundle"):
            jgm.read_gain_map_bundle(blob[:cut])


# ------------------------------------------------------------- optimizer
def test_nelder_mead_equals_the_jax_search():
    def rosen(v):
        return (1 - v[0]) ** 2 + 100 * (v[1] - v[0] ** 2) ** 2

    tx, tf = topt.nelder_mead(rosen, [-1.2, 1.0], step=0.5, max_iter=400)
    jx, jf = jopt.nelder_mead(rosen, [-1.2, 1.0], step=0.5, max_iter=400)
    assert tf == jf < 1e-6 and np.array_equal(tx, jx)


def test_the_optimizer_cli_equals_the_jax_cli(tmp_path):
    """tests/test_tools.py:124's fork protocol, with the interpreter
    running the tests."""
    script = tmp_path / "objective.py"
    script.write_text(
        "#!" + sys.executable + "\n"
        "import os\n"
        "x = float(os.environ['VAR0']); y = float(os.environ['VAR1'])\n"
        "print((x - 3) ** 2 + (y + 1) ** 2, 'optimized')\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    argv = [script, "2", "30", "--step", "1.0", "--init", "0.5,0.5"]
    got = run(topt, argv)
    assert got == run(jopt, argv)
    assert got[0] == 0 and got[1].startswith("best objective: ")


# ------------------------------------------------- oracle and rd_measure
needs_libjxl = pytest.mark.skipif(not joracle.available(),
                                  reason="no system libjxl")


@needs_libjxl
def test_the_oracle_equals_the_jax_oracle(files):
    d, img = files
    assert toracle.available() and toracle.version() == joracle.version()
    for kw in ({"distance": 1.0, "effort": 3}, {"lossless": True,
                                                "effort": 1}):
        ref = joracle.encode(img, **kw)
        assert toracle.encode(img, **kw) == ref
        (ta, tinfo), (ja, jinfo) = toracle.decode(ref), joracle.decode(ref)
        assert np.array_equal(ta, ja) and tinfo == jinfo
    ours = (d / "e3.jxl").read_bytes()
    assert np.array_equal(toracle.decode(ours)[0], joracle.decode(ours)[0])
    jpg = (d / "photo.jpg").read_bytes()
    assert toracle.encode_jpeg(jpg) == joracle.encode_jpeg(jpg)


@needs_libjxl
@pytest.mark.parametrize("src", ["photo.ppm", "e3.jxl"])
def test_rd_measure_on_the_host_prints_the_jax_table(files, src):
    d, img = files
    small = d / f"rd-{src}"
    if src.endswith("ppm"):
        save_image(small, img[:40, :48])
    else:
        small.write_bytes(tcs.encode_lossy(img[:40, :48], effort=3,
                                           device=None))
    got = run(trd, [small, "--host"])
    assert got == run(jrd, ["rd_measure", small])
    assert got[0] == 0 and "over 12 cells" in got[1]


@needs_libjxl
def test_rd_measure_asks_for_the_card_to_decode_a_jxl(files, no_card):
    d, _ = files
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trd.main([str(d / "e3.jxl")])


# ---------------------------------------------------------- card default
CARD_CLIS = {
    "decode_and_encode": (tdae, ["{d}/e3.jxl", "{d}/x.ppm"]),
    "jxl_from_tree": (ttree, ["{d}/tree.txt", "{d}/x.jxl", "{d}/x.ppm"]),
    "cjpegli": (tcjpegli, ["{d}/e3.jxl", "{d}/x.jpg"]),
    "butteraugli_main": (tba, ["{d}/photo.ppm", "{d}/e3.jxl"]),
    "ssimulacra2_main": (ts2, ["{d}/e3.jxl", "{d}/photo.ppm"]),
    "hdr": (thdr, ["tone_map", "{d}/e3.jxl", "{d}/x.npy"]),
    "icc_simplify": (tsimplify, ["{d}/e3.jxl"]),
}


@pytest.mark.parametrize("tool", sorted(CARD_CLIS))
def test_each_cli_asks_for_the_card_by_default(files, tool, no_card):
    d, _ = files
    (d / "tree.txt").write_text(textwrap.dedent(TREES["weighted"]))
    mod, argv = CARD_CLIS[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([a.format(d=d) for a in argv])


# -------------------------------------------------------------- modules
TOOLS = ("conformance", "fuzz", "decode_and_encode", "jxl_from_tree",
         "rd_measure", "cjpegli", "djpegli", "butteraugli_main",
         "ssimulacra2_main", "hdr", "icc_simplify", "optimizer")

_HELP_ALL = """
import contextlib, io, runpy, sys
for name in sys.argv[1:]:
    sys.argv = [name, "--help"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_module(f"libjxl_tpu_torch.tools.{name}",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, (name, e.code)
    print(f"=={name}== " + out.getvalue().replace("\\n", " "))
"""


@pytest.fixture(scope="module")
def helps():
    """Each tool's --help as `python -m` gives it, from one process."""
    res = subprocess.run([sys.executable, "-c", _HELP_ALL, *TOOLS],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "COLUMNS": "100"})
    assert res.returncode == 0, res.stderr[-3000:]
    return {line.split("==")[1]: line for line in res.stdout.splitlines()
            if line.startswith("==")}


@pytest.mark.parametrize("tool", TOOLS)
def test_each_tool_runs_as_a_module(helps, tool):
    assert "usage:" in helps[tool]
    if tool not in ("djpegli", "optimizer", "conformance", "hdr"):
        assert "--device" in helps[tool] and "--host" in helps[tool]
