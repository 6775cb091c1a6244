"""libjxl_tpu_torch/tools' ports of the root scripts
tools/gen_conformance_corpus.py and tools/anchor_butteraugli.py against
those scripts: the same images byte for byte, the same refusal without a
system libjxl, and, where the system libjxl is present, the same corpus
files and the same anchor tables (on small cases: each script is
monkeypatched to write under tmp_path, never into tests/data or docs)."""

import importlib.util
import json
import pathlib

import pytest

from libjxl_tpu_torch.extras import oracle
from libjxl_tpu_torch.tools import anchor_butteraugli as tanchor
from libjxl_tpu_torch.tools import gen_conformance_corpus as tgen

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _script(name):
    """A root tools/ script as a module (it imports the JAX package)."""
    spec = importlib.util.spec_from_file_location(
        f"root_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jgen():
    return _script("gen_conformance_corpus")


@pytest.fixture(scope="module")
def janchor():
    return _script("anchor_butteraugli")


def _same_image(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_corpus_cases_and_images_equal_the_scripts(jgen):
    assert [(n, kw, pt) for n, _, kw, pt in tgen.CASES] \
        == [(n, kw, pt) for n, _, kw, pt in jgen.CASES]
    for (_, make, _, _), (_, jmake, _, _) in zip(tgen.CASES, jgen.CASES):
        _same_image(make(), jmake())
    _same_image(tgen._photo(seed=21), jgen._photo(seed=21))  # the JPEG


def test_anchor_images_equal_the_scripts(janchor):
    got = tanchor.images()
    assert [n for n, _ in got] == ["photo", "texture", "edges"]
    for (_, img), ref in zip(got, (janchor._photo(), janchor._texture(),
                                   janchor._edges())):
        _same_image(img, ref)


@pytest.mark.parametrize("tool", ["gen", "anchor"])
def test_tools_without_libjxl_return_1(tool, jgen, janchor, monkeypatch,
                                       tmp_path, capsys):
    """Both return 1 with the scripts' message and write nothing."""
    port, script = (tgen, jgen) if tool == "gen" else (tanchor, janchor)
    monkeypatch.setattr(oracle, "available", lambda: False)
    monkeypatch.setattr(script.oracle, "available", lambda: False)
    out = tmp_path / "out"
    assert port.main(["--out", str(out), "--device", "cpu"]) == 1
    msg = capsys.readouterr().err
    assert script.main() == 1
    assert msg == capsys.readouterr().err != ""
    assert not out.exists()


@pytest.mark.parametrize("tool", [tgen, tanchor],
                         ids=["gen", "anchor"])
def test_tools_need_an_out_path(tool):
    with pytest.raises(SystemExit):
        tool.main([])


def _need_libjxl():
    if not oracle.available():
        pytest.skip("needs the system libjxl (extras/oracle)")


@pytest.mark.parametrize("flags", [["--host"], ["--device", "cpu"]],
                         ids=["host", "cpu"])
def test_gen_corpus_writes_the_scripts_corpus(flags, jgen, monkeypatch,
                                              tmp_path):
    """Two cases and the JPEG pair: the same stream and reference bytes,
    and the same manifest, our decode's error included; with --device
    cpu (the kernels' twins, within 1 u8 step of the host decode) the
    lossy case's error within 1 step."""
    _need_libjxl()
    cases = ("lossless_photo_e3", "lossy_photo_d1_e3")
    monkeypatch.setattr(tgen, "CASES",
                        [c for c in tgen.CASES if c[0] in cases])
    monkeypatch.setattr(jgen, "CASES",
                        [c for c in jgen.CASES if c[0] in cases])
    monkeypatch.setattr(jgen, "OUT", str(tmp_path / "jax"))
    assert jgen.main() == 0
    assert tgen.main(["--out", str(tmp_path / "port"), *flags]) == 0
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 2 * len(cases) + 3
    for name in names:
        if name != "manifest.json":
            assert (tmp_path / "port" / name).read_bytes() \
                == (tmp_path / "jax" / name).read_bytes(), name
    got, ref = (json.loads((tmp_path / d / "manifest.json").read_text())
                for d in ("port", "jax"))
    assert [c["name"] for c in got["cases"]] == [*cases, "jpeg_recon"]
    if flags == ["--host"]:
        assert got == ref
        return
    for g, r in zip(got["cases"], ref["cases"]):
        if g.get("kind") == "lossy":
            assert abs(g.pop("gen_rmse") - r.pop("gen_rmse")) <= 1.0
            assert abs(g.pop("gen_peak") - r.pop("gen_peak")) <= 1
        assert g == r


@pytest.mark.parametrize("flags", [["--host"], ["--device", "cpu"]],
                         ids=["host", "cpu"])
def test_anchor_writes_the_scripts_tables(flags, janchor, monkeypatch,
                                          tmp_path):
    """The three images cut to 32x32 in both tools: the same tables."""
    _need_libjxl()
    small = [(n, img[:32, :32]) for n, img in tanchor.images()]
    monkeypatch.setattr(tanchor, "images", lambda: small)
    for name, img in small:
        monkeypatch.setattr(janchor, f"_{name}", lambda img=img: img)
    monkeypatch.setattr(janchor, "OUT", str(tmp_path / "jax.md"))
    assert janchor.main() == 0
    out = tmp_path / "port.md"
    assert tanchor.main(["--out", str(out), *flags]) == 0
    got = out.read_text().splitlines()
    ref = (tmp_path / "jax.md").read_text().splitlines()
    assert got[2] == ref[2].replace(
        "tools/", "libjxl_tpu_torch/tools/", 1)
    assert got[:2] + got[3:] == ref[:2] + ref[3:]
    assert sum(line.startswith("| photo |") for line in got) == 2 + 4
