"""Test configuration: force an 8-device virtual CPU mesh.

Multi-chip TPU hardware is unavailable in CI; sharding tests run on a
virtual 8-device CPU mesh per the project plan (SURVEY.md section 2.10).
Must run before the first jax import.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written "
        "kernels); skipped without one")
