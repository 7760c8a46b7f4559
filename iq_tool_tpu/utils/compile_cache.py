"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it stands (JAX
reads it itself) and no other directory is set.  Otherwise the cache
lives at ``<checkout>/.jax_cache``: a fixed path, because the path is
part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV = "JAX_COMPILATION_CACHE_DIR"


def enable() -> str:
    """Point the compilation cache at its directory; returns that path."""
    path = os.environ.get(ENV)
    if path:
        return path
    import jax
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
