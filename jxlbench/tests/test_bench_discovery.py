"""A configuration, a traffic mix and a per-layer metric added as files,
from a folder of their own, run without an edit to the harness."""

import json

from .conftest import run_cpu, tiny


def test_added_files_run(tmp_path):
    root, bench = tiny(tmp_path, size=256, streams=2)
    cfg = json.loads((root / "configs" / "photo2k_d1_e5.json").read_text())
    cfg.update(effort=4, streams=3)
    (root / "configs" / "photo256_e4.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "pairs.json").write_text(json.dumps({
        "entry": "decode", "per_call": 2, "warmup_calls": 1,
        "args": {"num_threads": 1}, "require": {"path_prefix": "device:"},
        "keep": {"sampled": 1, "last": 1}}))
    (bench / "metrics" / "calls_seen.pairs.py").write_text(
        "def read(ctx):\n    return float(len(ctx.calls))\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "photo256_e4", "source": "test",
                         "file": "configs/photo256_e4.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "photo256_e4.pairs",
                           "config": "photo256_e4", "traffic": "pairs",
                           "chips": 1, "why": "a test"})
    m["end_to_end"][1]["workloads"].append("photo256_e4.pairs")
    m["per_layer"].append({"name": "calls_seen.pairs", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "single_ms",
                           "workloads": ["photo256_e4.pairs"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    out, lines = run_cpu(root, bench, "photo256_e4.pairs", trace=True)
    assert out["correct"], lines
    assert out["metrics"]["calls_seen.pairs"]["value"] == out["attempted"]
    assert "decode_p95_ms.single" not in out["metrics"]
    out, lines = run_cpu(root, bench, "photo256_e4.pairs")
    assert set(out["metrics"]) == {"single_ms", "setup_s"}
    assert list(out)[-1] == "compared"
