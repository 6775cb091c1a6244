"""The control of the comparison: the reference put in the program's place,
computed a precision lower (the maker's control(), for the VarDCT
configurations compare.bf16_stages), read by the same numbers as a run's
outputs, on the configuration's streams at their full size.

    python3 -m jxlbench.control --config photo2k_d1_e3 --seeds 1 2 3

from the root of a checkout. Prints one JSON line a seed: the numbers, the
limits and whether the control came out as correct (it must not). The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import multiprocessing as mp
import os
import pathlib
import sys

import numpy as np

from . import compare
from .harness import load_manifest
from .inputs import load_or_make, maker


def _one(args):
    """Pool worker: the control's image of one stream, with the
    reference's beside it, as (max_steps, off values, values)."""
    config, stream, ref_path = args
    img = maker(config).control(stream)
    tally = compare.Tally()
    tally.add(img, np.load(ref_path))
    return tally.max_steps, tally.off, tally.values


def control(root: pathlib.Path, config: dict, seed: int,
            workers: int | None = None) -> dict:
    inputs, _ = load_or_make(root, config, seed)
    jobs = [(config, s, str(inputs.folder / f"r{i}.npy"))
            for i, s in enumerate(inputs.streams)]
    tally = compare.Tally()
    with cf.ProcessPoolExecutor(
            max_workers=workers or min(len(jobs), os.cpu_count() or 1),
            mp_context=mp.get_context("spawn")) as pool:
        for steps, off, values in pool.map(_one, jobs):
            tally.max_steps = max(tally.max_steps, steps)
            tally.off += off
            tally.values += values
            tally.images += 1
    correct, numbers = tally.verdict(config["limits"])
    return {"config": config["name"], "seed": seed, "images": tally.images,
            "correct": correct,
            "compared": {k: {"value": v, "limit": lim}
                         for k, (v, lim) in numbers.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    root = pathlib.Path.cwd()
    entry = {c["name"]: c for c in load_manifest(root)["configs"]}[
        args.config]
    config = json.loads((root / entry["file"]).read_text())
    config["name"] = entry["name"]
    for seed in args.seeds:
        print(json.dumps(control(root, config, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
