"""Persistent compilation cache at a fixed path.

Compiling the GPU kernel and the engine's jitted steps takes tens of
seconds on a cold process. JAX keeps compiled executables across processes
in a persistent cache. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it and nothing is configured here. Otherwise the cache goes to
``<checkout>/.jax_cache`` — a fixed path, since the directory is part of
what a later process must find again.

Call :func:`enable_compile_cache` before the first compilation of the
process: JAX decides once, at that compilation, whether a cache is used.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Returns the cache directory in use (the env var's, or the default
    set here)."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    if jax.config.jax_compilation_cache_dir != DEFAULT_DIR:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
