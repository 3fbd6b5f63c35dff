"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (``chip_smoke.py``, ``bench.py``,
``bench_full.py``, the CLI and the test suite): a directory already in
force — ``JAX_COMPILATION_CACHE_DIR``, which JAX reads into
``jax_compilation_cache_dir`` itself, or one the process set earlier — is
kept and nothing here sets another; otherwise the cache goes to
``<repo>/.jax_cache`` (listed in ``.gitignore``), a fixed path so that
later runs hit it.
"""

from __future__ import annotations

import os

__all__ = ["REPO_ROOT", "enable_compile_cache"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache(default_dir: str | None = None) -> str:
    """Return the cache directory in force, setting it only if none is;
    ``default_dir`` replaces ``<repo>/.jax_cache``."""
    import jax

    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    path = default_dir or os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
