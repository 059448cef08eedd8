"""Persistent XLA compile cache placement, for the entry points.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself; when it is set this module
changes nothing. Otherwise the cache goes to one fixed directory inside the
checkout (`.jax_cache/`, git-ignored), so a later process on the same tree
finds what an earlier one compiled. The path never depends on a temporary
name, a pid or the time: the cache key includes it.

Called by the entry points (chip_smoke.py, bench.py, the app, the
profiler); library imports and tests leave the cache alone.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Return the compile-cache directory in use, setting the in-checkout
    default only when the environment names none."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
