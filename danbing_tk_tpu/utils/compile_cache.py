"""Persistent XLA compilation cache.

Production-size align programs take long to compile; without a
persistent cache that cost recurs at every process launch.  JAX's disk
cache makes relaunch/resume pay it once per (program, shape, backend).

Called by the align CLI on --device and by the bench tools.  Where
JAX_COMPILATION_CACHE_DIR is set, JAX keeps the cache there and this
module sets no other directory; otherwise the cache lives at the fixed
<repo>/build/jaxcache (the path is part of the cache key, so it must not
move between runs).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "jaxcache")

_enabled = False


def enable_compile_cache() -> str:
    """Idempotently turns on the persistent compile cache; returns its
    directory."""
    global _enabled
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    if _enabled:
        return path
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _enabled = True
    return path
