"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names; the reference imports nothing of the port
either."""

import ast
import json
import subprocess
import sys

from .conftest import BENCH, ROOT

JAX = {"jax", "jaxlib", "flax", "libjxl_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_in_a_run(tmp_path):
    from .conftest import run_cpu, tiny

    root, bench = tiny(tmp_path)
    code = (
        "import pathlib, json\n"
        "from jxlbench import harness, control, readers, trace, work\n"
        f"bench = pathlib.Path({str(bench)!r})\n"
        "for f in sorted((bench / 'metrics').glob('*.py')):\n"
        "    harness.load_module(f, 'm_' + f.stem)\n"
        "if __name__ == '__main__':\n"
        f"    out = harness.run(pathlib.Path({str(root)!r}), "
        "'photo2k_d1_e5.single', 3, 0.2, True, device_kind='cpu', "
        "log=lambda m: None, bench_dir=bench)\n"
        "    assert out['correct'], out\n")
    names = loaded_after(code)
    assert not names & JAX, names & JAX
    assert "libjxl_tpu_torch" in names  # the port ran


def test_reference_imports_nothing_of_the_port():
    names = loaded_after(
        "from jxlbench import compare\n"
        "from jxlbench.makers import vardct_photo as photo\n"
        "cfg = {'height': 256, 'width': 256, 'distance': 1.0, "
        "'effort': 5}\n"
        "s = photo.encode(cfg, photo.image_for(cfg, 1, 0))\n"
        "photo.reference(s)\n"
        "photo.reference(s, lower=compare.bf16_stages)\n")
    assert not names & (JAX | {"libjxl_tpu_torch"}), names


def test_sources_import_no_jax():
    """The import statements of every file under jxlbench/."""
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & JAX, (path, tops)
            if "refcodec" in path.parts:
                assert "libjxl_tpu_torch" not in tops, path
