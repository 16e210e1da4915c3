"""Persistent XLA compilation cache: the one place that says where it lives.

A cold process compiles every program it runs; the scanned training
program of a large graph takes tens of seconds to compile. JAX's
persistent cache keeps compiled programs on disk, keyed among other things
by the cache path, so the path must not move between runs.

Every entry point calls :func:`enable_compile_cache` before its first
compilation.
"""

from __future__ import annotations

import os

import jax

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
# fixed, inside the checkout, listed in .gitignore
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it into
    ``jax_compilation_cache_dir`` and the cache stays there; otherwise the
    cache goes to :data:`DEFAULT_CACHE_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        if jax.config.jax_compilation_cache_dir != env:
            jax.config.update("jax_compilation_cache_dir", env)
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
