"""Where JAX keeps its persistent compilation cache for this checkout."""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing. Otherwise the cache is ``<checkout>/.jax_cache`` (listed in
    ``.gitignore``): a fixed path, because the path is part of the cache key.
    Returns the directory in use. Called by the entry points, never at
    import.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
