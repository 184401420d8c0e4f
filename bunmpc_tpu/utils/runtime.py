"""Process-level JAX runtime setup shared by every entry point."""

from __future__ import annotations

import os

# The checkout root: <checkout>/bunmpc_tpu/utils/runtime.py
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cache_dir() -> str:
    """Persistent compilation cache directory: ``$JAX_COMPILATION_CACHE_DIR``
    if set, else ``<checkout>/.jax_cache``. The path is part of the cache key,
    so it is fixed and does not depend on the working directory."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(REPO_ROOT, ".jax_cache")


def setup_jax() -> str:
    """Enable the persistent compilation cache; returns its directory.

    The only place in the repo that sets ``jax_compilation_cache_dir``. Call it
    before the first compilation."""
    import jax

    d = cache_dir()
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return d
