"""Shared set-up of the benchmark's own tests (run them with
`python -m pytest jxlbench/tests` from the repository's root). They run on
the CPU; those marked `cuda` need a card and skip without one."""

import json
import pathlib
import shutil

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "jxlbench"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the benchmark's chip runs)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny(tmp_path, size=256, streams=2, per_call=None, warmup=1,
         effort=None, distance=None):
    """A checkout root and a benchmark folder under tmp_path that hold the
    real manifest's cells at `size` x `size` with `streams` streams a
    seed; traffic mixes take `per_call` streams a call (batch mixes only)
    and `warmup` warm-up calls; no mix asks for a kernel launch. Returns
    (root, bench_dir)."""
    root, bench = tmp_path / "root", tmp_path / "bench"
    (root / "configs").mkdir(parents=True)
    for sub in ("entries", "metrics", "makers"):
        shutil.copytree(BENCH / sub, bench / sub)
    shutil.copy(BENCH / "spans.json", bench / "spans.json")
    (bench / "traffic").mkdir()
    m = manifest()
    for c in m["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(height=size, width=size, streams=streams)
        if effort is not None:
            cfg["effort"] = effort
        if distance is not None:
            cfg["distance"] = distance
        c["file"] = f"configs/{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    for t in (BENCH / "traffic").glob("*.json"):
        tr = json.loads(t.read_text())
        if per_call and tr["per_call"] > 1:
            tr["per_call"] = tr["batch"] = per_call
            if "batch_size" in tr["args"]:
                tr["per_call"] = 2 * per_call
                tr["args"]["batch_size"] = per_call
        tr["warmup_calls"] = warmup
        # the CPU runs the kernels' plain twins, which count no launch
        tr.get("require", {}).pop("launches", None)
        (bench / "traffic" / t.name).write_text(json.dumps(tr))
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root, bench


def add_cell(root, config, traffic, e2e, chips=1):
    """A workload of `config` under `traffic` added to the tiny manifest,
    reporting the end-to-end metric `e2e` and setup_s. Returns its name."""
    name = f"{config}.{traffic}"
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": name, "config": config,
                           "traffic": traffic, "chips": chips,
                           "why": "a test"})
    for e in m["end_to_end"]:
        if e["name"] == e2e:
            e["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return name


def run_cpu(root, bench, workload, seed=123, seconds=0.3, trace=False,
            chips=None, **kw):
    """harness.run on the CPU, the cell cut to `chips` entries."""
    from jxlbench import harness

    if chips is not None:
        m = json.loads((root / "BENCHMARK.json").read_text())
        for w in m["workloads"]:
            w["chips"] = min(w["chips"], chips)
        (root / "BENCHMARK.json").write_text(json.dumps(m))
    lines = []
    out = harness.run(root, workload, seed, seconds, trace,
                      device_kind="cpu", log=lines.append, bench_dir=bench,
                      **kw)
    return out, lines
