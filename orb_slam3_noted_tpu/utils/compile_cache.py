"""Persistent XLA compilation cache for the program's entry points.

One rule for every entry point (``cli``, ``node``, ``demo``, ``bench.py``,
``chip_smoke.py``) and the test suite: when ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX already reads it and nothing here overrides it; otherwise the cache
lives at the fixed ``<checkout>/.jax_cache``.  The directory is part of the
cache key, so it never depends on a temporary path, a process id or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    """The directory the compilation cache uses under the rule above."""
    return os.environ.get(ENV_VAR) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`cache_dir`; returns it."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
