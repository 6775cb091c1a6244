"""libjxl_tpu_torch stands alone: no file imports the JAX package or JAX,
at module level or inside a function, and importing every module of the
port loads neither."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("libjxl_tpu", "jax", "jaxlib")
SOURCES = sorted((ROOT / "libjxl_tpu_torch").rglob("*.py"))


def _imports(path: pathlib.Path):
    """(line, top-level package) of every absolute import in `path`."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [(line, mod) for line, mod in _imports(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_walker_sees_imports_inside_functions(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("from . import x\n\ndef f():\n"
                   "    from libjxl_tpu.io import bits\n"
                   "    import jax.numpy\n")
    assert list(_imports(src)) == [(4, "libjxl_tpu"), (5, "jax")]


PORT = ROOT / "libjxl_tpu_torch"
PORT_SOURCES = sorted(PORT.rglob("*.py"))


def _relative_imports(path: pathlib.Path):
    """(line, target path) of every relative import in `path`, lazy ones
    included: the module a `from .x import y` names, or, for `from .
    import y`, the package's y."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.ImportFrom) and node.level:
            base = path.parent
            for _ in range(node.level - 1):
                base = base.parent
            if node.module:
                yield node.lineno, base.joinpath(*node.module.split("."))
            else:
                for alias in node.names:
                    yield node.lineno, base / alias.name


def _resolves(target: pathlib.Path) -> bool:
    return target.with_suffix(".py").is_file() \
        or (target / "__init__.py").is_file()


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_SOURCES])
def test_every_relative_import_resolves_to_a_port_file(path):
    missing = [(line, str(t.relative_to(ROOT)))
               for line, t in _relative_imports(path) if not _resolves(t)]
    assert not missing, f"{path.relative_to(ROOT)} imports {missing}"


def test_relative_import_walker_sees_lazy_and_package_imports(tmp_path):
    pkg = tmp_path / "pkg" / "sub"
    pkg.mkdir(parents=True)
    (tmp_path / "pkg" / "__init__.py").write_text("")
    (pkg / "__init__.py").write_text("")
    (tmp_path / "pkg" / "there.py").write_text("")
    src = pkg / "m.py"
    src.write_text("from . import gone\n\ndef f():\n"
                   "    from ..there import x\n"
                   "    from ..absent import y\n")
    got = [(line, _resolves(t)) for line, t in _relative_imports(src)]
    assert got == [(1, False), (4, True), (5, False)]


_IMPORT_ALL = textwrap.dedent("""
    import importlib, pkgutil, sys
    import libjxl_tpu_torch
    for m in pkgutil.walk_packages(libjxl_tpu_torch.__path__,
                                   "libjxl_tpu_torch."):
        importlib.import_module(m.name)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("libjxl_tpu", "jax", "jaxlib"))
    print("LOADED", len([m for m in sys.modules
                         if m.startswith("libjxl_tpu_torch.")]))
    assert not bad, bad
""")


def test_importing_every_module_loads_neither():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split("LOADED")[1]) > 40
