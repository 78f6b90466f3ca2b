"""JAX's persistent compilation cache, set up one way for every entry point
(the CLI, ``bench.py`` and ``chip_smoke.py``).

A cold process compiles every dispatch shape it meets, which takes seconds
to minutes on a GPU; the cache keeps those executables across processes.
Its directory is part of the cache key, so it is a fixed path: the one
``JAX_COMPILATION_CACHE_DIR`` names when it is set (JAX reads that variable
itself, so nothing else is set), else ``<repo>/.jax_cache``.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str | None:
    """Turn the persistent cache on for an accelerator backend and return
    its directory; return None on the CPU, which runs cache-free because
    XLA:CPU executable deserialization has been seen to crash."""
    import jax

    if jax.default_backend() == "cpu":
        return None
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return str(REPO_CACHE_DIR)
