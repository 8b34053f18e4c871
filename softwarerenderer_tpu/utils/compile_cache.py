"""JAX's persistent compilation cache, in one place.

Every entry point (bench.py, chip_smoke.py, the apps' mains, scripts/ and
the test configuration) calls ``enable_compile_cache()`` before its first
compile.  If ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is used
and no other; otherwise the cache lives in ``<checkout>/.jax_cache``,
which ``.gitignore`` lists.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the cache uses: $JAX_COMPILATION_CACHE_DIR, else
    <checkout>/.jax_cache."""
    return os.environ.get(ENV) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir(); returns
    the directory."""
    import jax
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
