"""JAX's persistent compilation cache, one rule for every entry point.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
is set here. Otherwise the cache lives in `<checkout>/.jax_cache` (listed
in `.gitignore`): a fixed path, since the path is part of the cache key.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
