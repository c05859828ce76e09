"""Persistent XLA compile cache for the programs that drive the device.

Scripts (``chip_smoke.py``, ``bench.py``, ``examples/``) call
:func:`enable_compile_cache` once at start-up; importing the library sets no
global JAX configuration. ``JAX_COMPILATION_CACHE_DIR``, when set, is left to
JAX, which reads it itself. Otherwise the cache lives at ``.jax_cache`` in
the checkout: a fixed path, because the path is part of what makes a cached
program findable again.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the compile cache uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
