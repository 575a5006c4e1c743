"""Persistent compilation cache setup.

The analog of the reference's prebuilt-bitstream reuse (TAPAB env,
README.md:46-48): compiled executables are kept on disk so later processes
skip compilation. The directory is ``JAX_COMPILATION_CACHE_DIR`` when that
is set (JAX reads it itself), and otherwise the fixed ``<repo>/.jax_cache``:
the path is part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent.parent / ".jax_cache"


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(DEFAULT_CACHE_DIR)
        Path(cache_dir).mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
