"""The persistent XLA compilation cache's location.

`JAX_COMPILATION_CACHE_DIR` wins when it is set; otherwise the cache lives
in `.jax_cache` at the root of the checkout that holds this package. A
fixed path matters: the path is part of the cache key, so a directory that
moves never hits.
"""
from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()`."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
