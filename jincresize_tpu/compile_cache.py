"""Persistent XLA compilation cache at one fixed directory.

A cold process compiles every program it runs; at 4K/8K geometries that is
most of a short run. JAX's persistent cache keeps compiled executables on
disk, and only a directory that stays put is ever hit again.
"""

from __future__ import annotations

import os
from pathlib import Path

# <checkout>/.jax_cache (listed in .gitignore).
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads that variable itself
    and this sets nothing. Otherwise the cache is ``CACHE_DIR``. Returns the
    directory in use. Call before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    CACHE_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
