"""Persistent XLA compile cache location.

`JAX_COMPILATION_CACHE_DIR`, when set, names the cache and JAX reads it
itself, so nothing else is set. Otherwise the cache lives at a fixed path
inside the checkout (`<repo>/.jax_cache`, listed in .gitignore): a fixed
path is part of the cache key, so every run of this checkout finds what an
earlier run compiled.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    import jax

    if os.environ.get(ENV):
        return os.environ[ENV]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
