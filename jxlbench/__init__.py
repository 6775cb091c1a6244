"""The benchmark of libjxl_tpu_torch, the PyTorch and CUDA port, on NVIDIA
H100 cards. BENCHMARK.json at the repository's root names its cells;
`python3 -m jxlbench.run --help` runs one. It imports neither JAX nor the
JAX package libjxl_tpu; its reference decoder and input encoder are a
frozen copy of the port's host codec (refcodec/), which imports nothing
of the port."""
