"""JAX's persistent compilation cache for the entry points.

One rule for the CLI, the benchmark, the chip smoke test and the tools:
where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and this helper
sets no other path; otherwise the cache is ``<checkout>/.jax_cache``
(git-ignored). The path is part of the cache key, so it stays fixed.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    path = os.environ.get(ENV)
    if not path:
        path = os.path.join(CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
