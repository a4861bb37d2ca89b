"""Test harness: by default, an 8-device virtual CPU mesh.

Multi-chip sharding logic is validated on a fake mesh per SURVEY.md §4(c).
`JAX_PLATFORMS` selects another backend: tests marked `gpu` run only on an
NVIDIA GPU (`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py`)
and skip elsewhere.

A pytest plugin imports jax before this conftest runs, so env vars are
already bound — the CPU setup goes through jax.config.update, which works
until the backend is first used.
"""
import os

import jax

ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
if ON_CPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)
# XLA-CPU compiles are slow (~3s per unique tiny op shape); a persistent
# cache makes repeat test runs cheap.
from psgd_tf_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on any other backend"
    )
    if ON_CPU:
        assert jax.default_backend() == "cpu", (
            "tests must run on the CPU backend; backend is "
            f"{jax.default_backend()}"
        )
        assert jax.device_count() == 8
