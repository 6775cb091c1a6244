"""Nelder-Mead parameter search (tools/optimizer/simplex_fork.py analog).

Two surfaces:
- nelder_mead(f, x0, ...): in-process simplex minimization — used to
  tune encoder constants (quant scaling, heuristic weights) against a
  metric objective.
- CLI: ``optimizer <binary> <dimensions> <iterations> [--eps E]``
  forks ``binary`` with the candidate vector passed as environment
  variables VAR0..VARn-1 and parses the objective from a line
  ``<value> optimized`` on its stdout — the reference's external
  process protocol (simplex_fork.py:7-17).
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import numpy as np


def nelder_mead(f, x0, step=0.1, max_iter=200, xtol=1e-6, ftol=1e-9,
                callback=None):
    """Minimize f over R^n with the Nelder-Mead simplex method.

    Returns (best_x, best_f). step: initial simplex edge length
    (scalar or per-dimension array).
    """
    x0 = np.asarray(x0, dtype=np.float64)
    n = x0.size
    step = np.broadcast_to(np.asarray(step, dtype=np.float64), (n,))
    # initial simplex: x0 plus one vertex per axis
    pts = [x0.copy()]
    for i in range(n):
        v = x0.copy()
        v[i] += step[i] if step[i] != 0 else 0.1
        pts.append(v)
    vals = [float(f(p)) for p in pts]
    alpha, gamma, rho, sigma = 1.0, 2.0, 0.5, 0.5
    for it in range(max_iter):
        order = np.argsort(vals)
        pts = [pts[i] for i in order]
        vals = [vals[i] for i in order]
        if callback is not None:
            callback(it, pts[0], vals[0])
        spread = max(np.max(np.abs(p - pts[0])) for p in pts[1:])
        if spread < xtol and abs(vals[-1] - vals[0]) < ftol:
            break
        centroid = np.mean(pts[:-1], axis=0)
        xr = centroid + alpha * (centroid - pts[-1])
        fr = float(f(xr))
        if vals[0] <= fr < vals[-2]:
            pts[-1], vals[-1] = xr, fr
        elif fr < vals[0]:
            xe = centroid + gamma * (xr - centroid)
            fe = float(f(xe))
            if fe < fr:
                pts[-1], vals[-1] = xe, fe
            else:
                pts[-1], vals[-1] = xr, fr
        else:
            xc = centroid + rho * (pts[-1] - centroid)
            fc = float(f(xc))
            if fc < vals[-1]:
                pts[-1], vals[-1] = xc, fc
            else:  # shrink toward best
                for i in range(1, len(pts)):
                    pts[i] = pts[0] + sigma * (pts[i] - pts[0])
                    vals[i] = float(f(pts[i]))
    best = int(np.argmin(vals))
    return pts[best], vals[best]


_OPT_RE = re.compile(r"(-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)\s+optimized")


def _fork_objective(binary, n):
    """Objective evaluating an external process: vector -> VAR%d env
    vars, objective parsed from '<float> optimized' on stdout
    (simplex_fork.py:9-13)."""

    def f(x):
        env = dict(os.environ)
        for i in range(n):
            env[f"VAR{i}"] = repr(float(x[i]))
        out = subprocess.run([binary], env=env, capture_output=True,
                             text=True, check=False)
        m = _OPT_RE.search(out.stdout)
        if not m:
            raise RuntimeError(
                f"no '<value> optimized' line in output of {binary}:\n"
                f"{out.stdout[-500:]}")
        return float(m.group(1))

    return f


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="optimizer",
        description="Nelder-Mead search over an external process; the "
        "candidate vector is passed as VAR0..VARn-1 env vars and the "
        "objective read from a '<value> optimized' stdout line.")
    p.add_argument("binary", help="command to evaluate")
    p.add_argument("dimensions", type=int)
    p.add_argument("iterations", type=int)
    p.add_argument("--init", default=None,
                   help="comma-separated initial vector (default zeros)")
    p.add_argument("--step", type=float, default=0.1)
    args = p.parse_args(argv)
    x0 = (np.array([float(s) for s in args.init.split(",")])
          if args.init else np.zeros(args.dimensions))
    if x0.size != args.dimensions:
        p.error(f"--init has {x0.size} values, expected {args.dimensions}")
    f = _fork_objective(args.binary, args.dimensions)

    def report(it, x, v):
        print(f"iter {it}: f={v:.8g} x={list(np.round(x, 6))}",
              file=sys.stderr)

    best_x, best_f = nelder_mead(f, x0, step=args.step,
                                 max_iter=args.iterations,
                                 callback=report)
    print(f"best objective: {best_f:.10g}")
    for i, v in enumerate(best_x):
        print(f"VAR{i}={float(v)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
