"""Persistent XLA compilation cache placement for the repository's scripts.

Importing the library sets no cache; scripts that want one call
:func:`enable_compile_cache` before their first compilation.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["enable_compile_cache"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache(checkout_dir) -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
    lives in ``<checkout_dir>/.jax_cache``.  The path is part of the cache's
    key, so it never depends on a temporary directory, a PID or the time.
    Returns the directory in use.
    """
    import jax

    cache_dir = os.environ.get(ENV_VAR) or str(Path(checkout_dir).resolve() / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
