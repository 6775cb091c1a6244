"""The control, the reference computed in bfloat16 in the program's place,
comes out as not correct under each configuration's limits (at a size a
test run holds; on the chip at the cells' own size, PERF.md)."""

import json

import pytest

from jxlbench import control

from .conftest import ROOT, manifest


@pytest.mark.parametrize("name", [c["name"] for c in manifest()["configs"]])
def test_control_fails(tmp_path, name):
    entry = {c["name"]: c for c in manifest()["configs"]}[name]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    cfg.update(name=name, height=384, width=384, streams=2)
    got = control.control(tmp_path, cfg, 11, workers=2)
    assert got["images"] == 2
    assert got["correct"] is False
    c = got["compared"]
    assert c["off_share"]["value"] > 3 * c["off_share"]["limit"]
    assert c["max_steps"]["value"] > c["max_steps"]["limit"]


def test_bf16_rounding():
    import numpy as np

    from jxlbench.compare import to_bf16

    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 3.14159, -2.5e-3],
                 np.float32)
    got = to_bf16(x)
    assert got[0] == 1.0 and got[1] == 1.0  # a tie goes to even
    assert got[2] == 1.0 + 2 ** -6
    assert abs(got[3] - 3.14159) <= 3.14159 * 2 ** -8
    assert np.all((got.view(np.uint32) & 0xFFFF) == 0)
