"""Persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there and
this module sets nothing.  Otherwise the cache lives in a fixed directory
inside the checkout (``.jax_cache/``, listed in ``.gitignore``): the path
is part of the cache key, so a directory that moved would never hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir(environ=os.environ) -> str:
    """The directory the compile cache uses under ``environ``."""
    return environ.get(ENV_VAR) or CHECKOUT_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    path = cache_dir()
    if os.environ.get(ENV_VAR):
        return path             # JAX reads the variable itself
    import jax

    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
