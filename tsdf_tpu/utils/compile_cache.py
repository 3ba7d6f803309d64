"""The persistent compilation cache, configured in one place.

``JAX_COMPILATION_CACHE_DIR``, when set, decides where compiled programs
are kept, and nothing here overrides it. Otherwise the cache lives at
``<checkout>/.jax_cache``: a fixed path, so a later process of the same
checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir(environ=os.environ) -> str | None:
    """The directory to configure, or None when the environment's
    ``JAX_COMPILATION_CACHE_DIR`` governs."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> None:
    """Turn the persistent cache on at ``compile_cache_dir()``, unless a
    cache directory is already configured (by the environment or by the
    caller)."""
    path = compile_cache_dir()
    if path is not None and not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", path)
