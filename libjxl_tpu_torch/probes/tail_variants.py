"""Design variants of the render tail kernel (ops/csrc/render_tail.cu) on
one card, beside the committed form.

Each variant is the committed source with a few text substitutions: the
output tile, the threads a CTA, the rows a thread computes (a strip of 1 is
a thread a cell), the EPF division in place of the reciprocal, powf in
place of exp2(log2(x) / 2.4). nvcc builds every variant at once into
build/libjxl_tpu_torch/variants/, and each runs through its C entry on
synthetic in-gamut XYB of the main path's shape (16 x 2048^2, the default
filter tables): the default chain (Gaborish + 2 passes, u8 out), epf=3, and
each pass alone (XYB out), timed by CUDA events, with the default chain's
u8 distance from render_tail_plain.

    python -m libjxl_tpu_torch.probes.tail_variants

prints the card and a line a variant. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..base.device import card_line, resolve_device
from ..ops import build, pipeline
from ..render.pipeline import _sad_mul_map, gaborish_kernel

SOURCE = build._CSRC / "render_tail.cu"
OUT_DIR = build.BUILD_DIR / "variants"
CS = (40.0, 5.0, 3.5)
SIGMA_SCALES = (0.9, 1.0, 6.5)  # passes 0, 1, 2: the encoder's defaults

_THREADS = "constexpr int kThreads = 256;"
_STRIPS = ("constexpr int kGabStrip = 4;", "constexpr int kEpfStrip = 2;")
_RECIPROCAL = ("const float rden = 1.0f / den;\n", "n0 * rden", "n1 * rden",
               "n2 * rden")
_DIVISION = ("", "n0 / den", "n1 / den", "n2 / den")
_CURVE = "exp2f(log2f(fmaxf(v, 1e-12f)) * (1.0f / 2.4f))"


def _strips(gab: int, epf: int):
    return [(_STRIPS[0], f"constexpr int kGabStrip = {gab};"),
            (_STRIPS[1], f"constexpr int kEpfStrip = {epf};")]


# name -> ((tile rows, tile cols), [(text, replacement), ...])
VARIANTS = {
    "committed": (build.RENDER_TILE, []),
    "tile 32x64": ((32, 64), []),
    "tile 32x32": ((32, 32), []),
    "512 threads": (build.RENDER_TILE,
                    [(_THREADS, "constexpr int kThreads = 512;")]),
    "a cell a thread": (build.RENDER_TILE, _strips(1, 1)),
    "strips 2/2": (build.RENDER_TILE, _strips(2, 2)),
    "strips 4/4": (build.RENDER_TILE, _strips(4, 4)),
    "division": (build.RENDER_TILE, list(zip(_RECIPROCAL, _DIVISION))),
    "powf": (build.RENDER_TILE,
             [(_CURVE, "powf(fmaxf(v, 1e-12f), 1.0f / 2.4f)")]),
}
# (label, Gaborish, first pass, last pass, u8 out)
CHAINS = (("default", True, 1, 2, True), ("epf3", True, 0, 2, True),
          ("pass0", False, 0, 0, False), ("pass1", False, 1, 1, False),
          ("pass2", False, 2, 2, False))


def variant_source(name: str) -> str:
    """The committed source with the variant's substitutions; raises if
    one no longer matches the source."""
    text = SOURCE.read_text()
    for old, new in VARIANTS[name][1]:
        if old not in text:
            raise ValueError(f"variant {name!r}: {old!r} is not in "
                             f"{SOURCE.name}")
        text = text.replace(old, new)
    return text


def _compile(name: str) -> ctypes.CDLL:
    tile = VARIANTS[name][0]
    stem = name.replace(" ", "_").replace("/", "_")
    cu, so = OUT_DIR / f"{stem}.cu", OUT_DIR / f"{stem}.so"
    cu.write_text(variant_source(name))
    flags = [f for f in build.NVCC_FLAGS if not f.startswith("-DJXL_RENDER")]
    res = subprocess.run([build._nvcc(), *flags,
                          f"-DJXL_RENDER_TILE_H={tile[0]}",
                          f"-DJXL_RENDER_TILE_W={tile[1]}", "-shared", "-o",
                          str(so), str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on variant {name!r}:\n"
                           f"{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.jxl_render_tail.argtypes = build._SIGNATURES["jxl_render_tail"]
    lib.jxl_render_tail.restype = ctypes.c_int
    return lib


def inputs(dev, batch: int = 16, size: int = 2048, seed: int = 0):
    """Smooth in-gamut XYB with mild noise, per-block inv_sigma at real
    streams' values, the encoder's default Gaborish and SAD map."""
    g = torch.Generator(device=dev).manual_seed(seed)
    yy = torch.arange(size, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(size, device=dev, dtype=torch.float32)[None]
    smooth = 0.1 * torch.sin(xx * 0.3) * torch.cos(yy * 0.2)

    def noise(scale):
        return scale * torch.randn(batch, size, size, device=dev,
                                   generator=g)

    xyb = torch.stack([0.01 * smooth + noise(0.002),
                       0.45 + smooth + noise(0.02),
                       0.40 + 0.5 * smooth + noise(0.02)], 1).contiguous()
    isg = -2.5 + 2.2 * torch.rand(batch, size // 8, size // 8, device=dev,
                                  generator=g)
    sad = torch.from_numpy(_sad_mul_map(size, size, 2.0 / 3.0).astype(
        np.float32)).to(dev)
    gab = torch.from_numpy(np.stack(
        [gaborish_kernel(0.115169525, 0.061248592)] * 3).astype(
            np.float32)).to(dev)
    return xyb, isg, sad, gab


def _ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(dev) -> list[dict]:
    """Every variant built and timed on `dev`: a dict a variant, {chain:
    ms} plus the default chain's u8 steps and differing pixels against
    render_tail_plain."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with cf.ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(_compile, VARIANTS)))
    xyb, isg, sad, gab = inputs(dev)
    b, _, h, w = xyb.shape
    plain = pipeline.render_tail_plain(xyb, gab, isg, sad, CS, 2,
                                       SIGMA_SCALES[0], SIGMA_SCALES[2],
                                       out="u8srgb")
    k = pipeline._consts()
    cs = np.asarray(CS, dtype=np.float32)
    scales = np.asarray(SIGMA_SCALES, dtype=np.float32)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    records = []
    for name, lib in libs.items():
        rec = {"variant": name, "tile": VARIANTS[name][0]}
        for label, with_gab, first, last, u8 in CHAINS:
            out = (torch.empty((b, h, w, 3), dtype=torch.uint8, device=dev)
                   if u8 else torch.empty_like(xyb))

            def launch():
                rc = lib.jxl_render_tail(
                    xyb.data_ptr(), out.data_ptr(), isg.data_ptr(),
                    sad.data_ptr(), gab.data_ptr() if with_gab else None,
                    first, last, int(u8), cs.ctypes.data, scales.ctypes.data,
                    k["opsin_inv"].ctypes.data, float(k["cbrt_bias"]),
                    float(k["bias"]), b, h, w, stream, dev.index)
                if rc:
                    raise RuntimeError(f"{name} {label}: CUDA error {rc}")

            rec[label] = _ms(launch)
            if label == "default":
                rec["u8_max_steps"] = int((out.int() - plain.int()).abs()
                                          .max())
                rec["u8_pixels_differ"] = int((out != plain).any(-1).sum())
        records.append(rec)
    return records


def main() -> int:
    dev = resolve_device("cuda")
    print(card_line(), flush=True)
    for rec in run(dev):
        print(f"{rec['variant']:>16} (tile {rec['tile'][0]}x"
              f"{rec['tile'][1]}): " + ", ".join(
                  f"{label} {rec[label]:.4f} ms" for label, *_ in CHAINS)
              + f"; default u8 vs plain: at most {rec['u8_max_steps']} "
              f"step, {rec['u8_pixels_differ']} pixels", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
