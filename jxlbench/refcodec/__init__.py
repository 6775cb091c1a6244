"""A frozen copy of libjxl_tpu_torch's host codec, cut to what the
benchmark runs: its reference decoder and the encoder of its inputs.

The modules are the port's host layers as they stood when the benchmark
was written (api/codestream, api/frame, base/status, entropy/, io/,
modular/, ops/{dct,xyb}, render/pipeline, vardct/, native_ext and the C
sources in native/), under the same paths, so that their relative imports
hold. What is left is what encode_lossy (efforts 1-5, on the host) and
decode (one 8-bit XYB VarDCT frame, on the host) reach; a stream feature
outside that (LZ77, prefix codes, modular transforms, custom dequant
tables, AFV blocks, extra channels, patches, splines, noise) raises
JXLError. native_ext builds its C library into .jxlbench/build/refcodec/
at the root of the checkout, and nothing here imports the port, JAX or
the JAX package. A change to the port's host code does not change this
copy, so the benchmark's reference and inputs stay what they were.
"""
