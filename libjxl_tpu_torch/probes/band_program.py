"""The sharded band render on one card, timed: one SIDE^2 d1/e3 photo
(the dry run's generator) encoded on the card, entropy-decoded on the
host, its inputs put on the card, then rendered whole (the single-device
render) and as ENTRIES row bands over a mesh of the cards in turn
(build_sharded_decode_stream): the band render's first call, then the mean
of REPS calls after WARM more (CUDA events), beside the whole render's
mean; the bands equal to the whole render exactly.

    python -m libjxl_tpu_torch.probes.band_program

prints the card line and one JSON line. It uses only entry points that
the port has had since its multi-device path (parallel/dryrun's
StreamRender and mesh_devices, sharding.make_mesh), so it times another
tree's builder too: from this tree's root, run this file with that
tree's root first on PYTHONPATH, as in

    PYTHONPATH=<other tree> python libjxl_tpu_torch/probes/band_program.py

and the JSON line names the tree it imported. Needs a CUDA card.
"""

import json
import pathlib
import sys
import time

import numpy as np
import torch

SIDE = 8192    # the JAX dry run's 64 MP image
ENTRIES = 4
SEED = 900
WARM = 2       # calls before the timed ones: a program captures at its 2nd
REPS = 10


def events_ms(fn, reps):
    """Mean CUDA-event ms of fn() over reps calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import libjxl_tpu_torch
    from libjxl_tpu_torch.api import codestream
    from libjxl_tpu_torch.base.device import card_line
    from libjxl_tpu_torch.parallel import dryrun, sharding

    if not torch.cuda.is_available():
        print("band_program: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    img = dryrun.photo(SIDE, np.random.default_rng(SEED))
    stream = codestream.encode_lossy(img, distance=1.0, effort=3,
                                     device=dev)
    sr = dryrun.StreamRender.of(stream).on(dev)
    setup_s = time.perf_counter() - t
    run = sr.sharded(sharding.make_mesh(dryrun.mesh_devices(ENTRIES,
                                                            "cuda")))
    with torch.inference_mode():
        whole = sr.single(dev)
        first = events_ms(lambda: run(*sr.args), 1)
        got = run(*sr.args)
        if not torch.equal(got.permute(1, 2, 0), whole):
            raise RuntimeError("band_program: the bands differ from the "
                               "whole render")
        for _ in range(WARM - 1):
            run(*sr.args)
        bands_ms = events_ms(lambda: run(*sr.args), REPS)
        whole_ms = events_ms(lambda: sr.single(dev), REPS)
    print(card_line(), flush=True)
    print(json.dumps({
        "tree": str(pathlib.Path(libjxl_tpu_torch.__file__).parent.parent),
        "image": f"{SIDE}^2 d1/e3", "entries": ENTRIES,
        "cards": torch.cuda.device_count(), "setup_s": setup_s,
        "bands_first_ms": first, "bands_ms": bands_ms, "whole_ms": whole_ms,
        "equal": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
