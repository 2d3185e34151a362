"""JAX's persistent compilation cache, located by one rule for every
entry point (CLI, server, benchmark, smoke run).

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads the variable
itself and nothing is set here.  Otherwise the cache lives in one fixed
directory inside the checkout (listed in ``.gitignore``), so repeated
runs from the same checkout reuse compiled executables.
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory it uses."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
