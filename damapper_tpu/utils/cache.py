"""Persistent XLA compile cache, so a second run skips recompiling."""

from __future__ import annotations

import os
import pathlib

# the default cache directory: one fixed path in the package's own build
# directory (inside the checkout when run from one), beside the native
# libraries' builds; the path is part of the cache key, so a moving
# directory would never hit
DEFAULT_DIR = (pathlib.Path(__file__).resolve().parents[1] / "build"
               / "xla_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    JAX_COMPILATION_CACHE_DIR, when set, wins: JAX reads it itself and no
    other directory is set here.  Otherwise the cache goes to DEFAULT_DIR.
    Safe to call more than once."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(DEFAULT_DIR)
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
