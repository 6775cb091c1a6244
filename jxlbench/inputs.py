"""A configuration's inputs for one seed: its codestreams and the reference
decode of each, made by the configuration's maker,
jxlbench/makers/<config["maker"]>.py (never by the program), and cached in
the checkout.

A maker holds make(config, seed, index) -> (stream bytes, reference u8
image, facts dict) and control(stream) -> the control's image.

The cache is <root>/.jxlbench/inputs/<config>/<seed>/: s<i>.jxl, r<i>.npy
(the reference's u8 image) and meta.json, written last, so that a cache
without meta.json is made again. Later runs of the seed read it.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import multiprocessing as mp
import os
import pathlib
import shutil
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent


def maker(config: dict, bench_dir: pathlib.Path = HERE):
    """The configuration's maker module."""
    from .harness import load_module

    name = config["maker"]
    return load_module(bench_dir / "makers" / f"{name}.py",
                       f"jxlbench_maker_{name}")


def _job(args):
    """Pool worker: one stream and its reference, written into `out`."""
    config, seed, index, out, bench_dir = args
    out = pathlib.Path(out)
    stream, img, facts = maker(config, pathlib.Path(bench_dir)).make(
        config, seed, index)
    (out / f"s{index}.jxl").write_bytes(stream)
    np.save(out / f"r{index}.npy", img)
    return {"index": index, **facts}


class Inputs:
    """A configuration's cached inputs at one seed: `streams` (bytes),
    `facts` (per stream, from the maker: as a rule bytes, height, width)
    and the reference images, read on demand (`reference(i)`)."""

    def __init__(self, folder: pathlib.Path, meta: dict):
        self.folder = folder
        self.facts = meta["streams"]
        self.streams = [(folder / f"s{i}.jxl").read_bytes()
                        for i in range(len(self.facts))]

    def reference(self, i: int) -> np.ndarray:
        return np.load(self.folder / f"r{i}.npy", mmap_mode="r")


def cache_dir(root: pathlib.Path, config: dict, seed: int) -> pathlib.Path:
    return root / ".jxlbench" / "inputs" / config["name"] / str(int(seed))


def load_or_make(root: pathlib.Path, config: dict, seed: int,
                 workers: int | None = None,
                 bench_dir: pathlib.Path = HERE) -> tuple[Inputs, str]:
    """The inputs of (config, seed) from the cache, made first where the
    cache lacks them, by a pool of spawned processes that has ended when
    this returns. Returns (inputs, "cached" or "made")."""
    folder = cache_dir(root, config, seed)
    meta_path = folder / "meta.json"
    if meta_path.exists():
        return Inputs(folder, json.loads(meta_path.read_text())), "cached"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    n = int(config["streams"])
    workers = workers or min(n, os.cpu_count() or 1)
    jobs = [(config, seed, i, str(folder), str(bench_dir))
            for i in range(n)]
    with cf.ProcessPoolExecutor(
            max_workers=workers,
            mp_context=mp.get_context("spawn")) as pool:
        facts = sorted(pool.map(_job, jobs), key=lambda f: f["index"])
    meta = {"config": config["name"], "seed": int(seed), "streams": facts,
            "made_at": time.time()}
    tmp = folder / "meta.json.tmp"
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, meta_path)
    return Inputs(folder, meta), "made"
