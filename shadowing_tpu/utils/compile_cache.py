"""Where JAX keeps its persistent compilation cache."""
from __future__ import annotations

import os
from pathlib import Path

import jax

#: fixed directory inside the checkout (listed in .gitignore): the path is
#: part of the cache key, so a directory that moved between runs would
#: never hit
DEFAULT_DIR = Path(__file__).resolve().parents[2] / "_jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is and nothing
    is configured here; otherwise the cache goes to :data:`DEFAULT_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
