"""Host-side parallel runners (JxlParallelRunner contract analog).

Mirrors the reference's fork-join surface (lib/include/jxl/
parallel_runner.h + lib/threads/thread_parallel_runner_internal.h):
- ThreadParallelRunner: a thread pool over independent tasks. Python
  threads parallelize for real here because the hot per-group work
  (native C modular decode, NumPy kernels) releases the GIL.
- FakeParallelRunner: runs tasks sequentially but in a seeded-random
  order (fake_parallel_runner_testonly.h:23-50) — tests use it to prove
  every fork-join body is order-independent.
- SequentialRunner: plain in-order execution (the default).
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor


class SequentialRunner:
    def run(self, tasks) -> None:
        for t in tasks:
            t()


class ThreadParallelRunner:
    """Fork-join over independent tasks (ThreadParallelRunner::Runner)."""

    def __init__(self, num_threads: int = 4):
        self.num_threads = max(1, num_threads)

    def run(self, tasks) -> None:
        tasks = list(tasks)
        if len(tasks) <= 1 or self.num_threads == 1:
            for t in tasks:
                t()
            return
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            futures = [pool.submit(t) for t in tasks]
            for f in futures:
                f.result()  # propagate exceptions


class FakeParallelRunner:
    """Seeded out-of-order sequential execution for tests."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def run(self, tasks) -> None:
        tasks = list(tasks)
        rng = random.Random(self.seed)
        rng.shuffle(tasks)
        for t in tasks:
            t()
