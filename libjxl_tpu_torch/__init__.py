"""libjxl_tpu_torch — the PyTorch/CUDA port of libjxl_tpu's device paths.

The JAX package `libjxl_tpu` stays the reference. This package keeps its
module paths and function names (minus the `_jax` suffix) and carries its
own copies of the host layers it needs, at the paths they have there:
base/status, io/, entropy/, modular/, vardct/, render/, extras/cms and
extras/exif, metrics/, ops/ans_tpu, ops/dct, ops/xyb, api/frame,
api/stats, api/codestream and native_ext with the C sources in native/,
built at first use into build/libjxl_tpu_torch/. It imports `torch`,
never `jax`, and nothing of `libjxl_tpu`. The entry points run on the
card unless the caller passes device="cpu" (or, to api/codestream's
decode, decode_frames and decode_batch, device=None: the host decode).

  base/device.py      device choice, precision policy, launch counters
  ops/pipeline.py     plain torch decode stages (the kernels' twins and
                      the other AC strategies' transforms)
  ops/ans_kernel.py   rANS lane plan, the decode's plain twin, placement
  ops/kernels.py      wrappers of the hand-written CUDA kernels
  ops/build.py        nvcc build of ops/csrc/*.cu, loaded with ctypes
  api/tpu_codec.py    batched VarDCT serving decode, host or device
                      entropy; the single-image render (make_device_render)
  probes/gather.py    the TPU gather probes S1-S6 as CUDA kernels + twins
  probes/prof_kernel.py  S7: K3's stream-copy floor
"""

__version__ = "0.1.0"
