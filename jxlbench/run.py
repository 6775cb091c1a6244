"""Run one cell of the benchmark once and print its result line.

    python3 -m jxlbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, jxlbench/ and the
port, libjxl_tpu_torch. Progress and the numbers compared go to standard
error; the last line of standard output is the result's JSON object. Exit
code 0 with a result; 2 for bad arguments; 1 when the run cannot give a
result (no card, too few cards, no port, JAX loaded), and nothing is
printed on standard output then.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys


def cache_env(root: pathlib.Path) -> None:
    """Every build and kernel cache in fixed directories of the checkout
    (the port's own nvcc and C builds go to <root>/build already)."""
    cache = root / ".jxlbench" / "cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = pathlib.Path.cwd()
    cache_env(root)
    from .harness import Refused, run

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    try:
        result = run(root, args.workload, args.seed, args.seconds,
                     bool(args.trace), log=log)
    except Refused as e:
        log(f"jxlbench: no result: {e}")
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
