"""On a card: one short run of each one-card cell, correct, with every
end-to-end metric (the chip runs' rehearsal; skipped without a card)."""

import json
import pathlib
import subprocess
import sys

import pytest

from .conftest import ROOT, manifest


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]
                                  if w["chips"] == 1])
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "jxlbench.run", "--workload", cell,
         "--seed", "4242", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    want = {e["name"] for e in manifest()["end_to_end"]
            if cell in e.get("workloads", [cell])}
    assert set(res["metrics"]) == want
