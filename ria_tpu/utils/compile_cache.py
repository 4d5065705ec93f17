"""Where JAX keeps its persistent compilation cache."""

from __future__ import annotations

import os

# One fixed directory inside the checkout (listed in .gitignore): a cache
# whose directory moves between runs is a cold cache.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here; otherwise the cache goes to ``CACHE_DIR``.  Call
    before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
