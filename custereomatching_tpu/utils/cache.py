"""Persistent XLA compilation cache shared by the scripts and tests.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, nothing
is configured here.  Otherwise the cache lives at one fixed path inside
the checkout (``<checkout>/.jax_cache``, listed in ``.gitignore``): the
directory is part of every entry's key, so a path that moved between
runs would never hit.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """Where the compilation cache is kept (see module docstring)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
