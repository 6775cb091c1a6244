"""Build the hand-written CUDA kernels and load them with ctypes.

`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC -c`
compiles each of ops/csrc/*.cu, which expose a plain C interface, in its
own process, all started together (the .cuh headers they include are
hashed with them), with the lanes a CTA of the rANS decode, CTA_LANES,
and the render tail's output tile, RENDER_TILE, compiled in; `nvcc
-shared` links the objects into
one shared library under build/libjxl_tpu_torch/ at the repository root.
The file name carries a hash of the sources and flags, so an edited
source builds anew and an unchanged one is loaded as it is. The build
runs at first use; importing this module needs no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("dequant_idct8.cu", "render_tail.cu", "ans_decode.cu",
           "gather_probe.cu", "ans_probe.cu")
HEADERS = ("ans_ring.cuh", "device_scope.cuh")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" \
    / "libjxl_tpu_torch"
# lanes a CTA of ans_decode.cu (one warp) decodes, all of one image: 1024
# lanes make 512 CTAs, about one a warp scheduler of the H100
# (ans_decode.cu's design note); ops/ans_kernel.cta_first builds its CTA
# table with it
CTA_LANES = 2
# (rows, cols) of render_tail.cu's output tile: 64 columns store a u8 row
# as 12 16-byte vectors; with the default chain's 4-px halo the CTA's
# buffers take 54 KB of shared memory, four CTAs an SM (32x64 tiles, two
# CTAs an SM, took a third longer on the H100: PERF.md)
RENDER_TILE = (16, 64)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DJXL_ANS_CTA_LANES={CTA_LANES}",
              f"-DJXL_RENDER_TILE_H={RENDER_TILE[0]}",
              f"-DJXL_RENDER_TILE_W={RENDER_TILE[1]}")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # inv8 (host), device
    "jxl_dequant_idct8_tables": (_P, _I),
    # qimg, q16, qf, dc, ytox, ytob, dm, igs, qb0..qb3, x_dm_mult,
    # b_dm_mult, B, H, W, nty, ntx, out, stream, device
    "jxl_dequant_idct8": (_P, _I, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F,
                          _F, _F, _I, _I, _I, _I, _I, _P, _P, _I),
    # in, out, inv_sigma, sad_mul, gab, first, last, u8, cs, sigma_scale,
    # opsin, cbrt_bias, bias, B, H, W, stream, device
    "jxl_render_tail": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _F, _F,
                        _I, _I, _I, _P, _I),
    # flat, total, lane_off, n_chains, bw, lane_img, a1, a2, nzclu, zdclu,
    # kz, alias_words, las, L, t_alloc, cta_first, n_cta, tape, ok, steps,
    # stream, device
    "jxl_ans_decode": (_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                       _I, _I, _P, _I, _P, _P, _P, _P, _I),
    # the same arguments; steps is an input
    "jxl_ans_stream_floor": (_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _I, _P, _I, _P, _P, _P, _P, _I),
    # T, gathers, shared, rowcol, table, state, iters, out, stream, device
    "jxl_probe_chain": (_I, _I, _I, _I, _P, _P, _I, _P, _P, _I),
    # depth, rule, mode, win, row_stride, col_mask, state, iters, out,
    # stream, device
    "jxl_probe_window": (_I, _I, _I, _P, _I, _I, _P, _I, _P, _P, _I),
    # body, shared, tbl, win, state, iters, out, stream, device
    "jxl_probe_table": (_I, _I, _P, _P, _P, _I, _P, _P, _I),
    # shared, tbl, state, H, W, axis, mod, group, iters, out, stream,
    # device
    "jxl_probe_take_along": (_I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                             _I),
    # a, o, n, stream, device
    "jxl_probe_noop": (_P, _P, _I, _P, _I),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME, "
                       "default /usr/local/cuda): the CUDA kernels cannot "
                       "be built")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return BUILD_DIR / f"libjxl_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless a library of these sources exists.

    Returns its path; the compiler's report (ptxas registers, shared
    memory, spills) is kept beside it as `<name>.log`."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{name}.o") for name in SOURCES]
    jobs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                              str(_CSRC / name)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for name, obj in zip(SOURCES, objs)]
    report, failed = [], []
    for name, job in zip(SOURCES, jobs):
        out, _ = job.communicate()
        report.append(f"== {name}\n{out}")
        if job.returncode != 0:
            failed.append(name)
    if not failed:
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)],
                             capture_output=True, text=True)
        report.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(report))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           + "".join(report))
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
