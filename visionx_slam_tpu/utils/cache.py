"""Where JAX keeps its persistent compilation cache.

Every entry point (CLI, bench, chip smoke, graft entry, tests) calls
``enable_compile_cache`` once before its first compile. The cache key
includes the directory, so the directory is fixed: ``JAX_COMPILATION_CACHE_DIR``
when the environment sets it (JAX reads that variable itself, so nothing
else is set), otherwise ``<checkout>/.jax_cache`` (listed in .gitignore).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT_DIR, ".jax_cache")


def compile_cache_dir(environ=os.environ) -> str:
    """The cache directory for this environment (no side effects)."""
    return environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``
    and return that directory."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
