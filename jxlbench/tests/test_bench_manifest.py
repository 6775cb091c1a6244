"""BENCHMARK.json against the benchmark's contract, and every file that it
names present: configurations and their makers, traffic mixes, entries
and metric readers."""

import json
import re

import pytest

from .conftest import BENCH, ROOT, manifest

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    m = manifest()
    assert set(m) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(m["command"]) <= 32
    assert all(one_line(w) for w in m["command"])
    assert m["paths"] == ["jxlbench"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[part]:
            extra = set(e) - KEYS[part]
            assert extra <= ({"workloads"} if part in ("end_to_end",
                                                        "per_layer")
                             else set()), (part, e["name"], extra)
            assert KEYS[part] <= set(e), (part, e["name"])


@pytest.mark.parametrize("part", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(part):
    m = manifest()
    names = [e["name"] for e in m[part]]
    assert len(names) == len(set(names))
    for e in m[part]:
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for k in ("why", "layer", "source"):
            if k in e:
                assert one_line(e[k]), (e["name"], k)
    if part == "workloads":
        for w in m[part]:
            assert NAME.fullmatch(w["config"]) and NAME.fullmatch(
                w["traffic"])
            assert w["chips"] in (1, 4)


def test_cells_and_metrics_agree():
    m = manifest()
    cells = {w["name"]: w for w in m["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) \
        == len(cells)
    assert sum(w["chips"] == 4 for w in cells.values()) \
        <= max(1, len(cells) // 4)
    configs = {c["name"] for c in m["configs"]}
    assert {w["config"] for w in cells.values()} == configs
    e2e = {e["name"]: set(e.get("workloads", cells)) for e in
           m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == set(cells)
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    layers = {}
    for p in m["per_layer"]:
        assert p["moves"] in e2e and p["moves"] != "setup_s"
        for w in p.get("workloads", cells):
            assert w in cells and w in e2e[p["moves"]], (p["name"], w)
        layers.setdefault(p["layer"].lower(), set()).add(p["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in cells:
        assert any(w in s for n, s in e2e.items() if n != "setup_s")
        assert any(w in p.get("workloads", cells) for p in m["per_layer"])


def test_named_files_exist():
    m = manifest()
    for c in m["configs"]:
        assert c["file"].startswith("jxlbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        for k in ("maker", "height", "width", "distance", "effort",
                  "streams", "limits", "assumed"):
            assert k in cfg, (c["name"], k)
        assert (BENCH / "makers" / f"{cfg['maker']}.py").exists()
        assert c["reduced"] == []
    for w in m["workloads"]:
        tr = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                        .read_text())
        assert (BENCH / "entries" / f"{tr['entry']}.py").exists()
    for p in m["end_to_end"] + m["per_layer"]:
        assert (BENCH / "metrics" / f"{p['name']}.py").exists(), p["name"]


def test_check_fits_with_24_cells():
    """A full check of 24 cells at this run length fits its time."""
    rs = manifest()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
