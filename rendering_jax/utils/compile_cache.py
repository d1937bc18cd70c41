"""Persistent XLA compilation cache.

The reference pays zero compile time (ahead-of-time C++); our jitted
pipelines pay a one-time XLA compile per (scene-shape, pass). JAX's
persistent compilation cache makes that a one-time cost across
processes: repeat CLI renders, benchmarks and animations of the same
scene shapes reuse the serialized executable from disk instead of
recompiling.

The directory is `JAX_COMPILATION_CACHE_DIR` when that is set (JAX
reads it itself; nothing here overrides it), otherwise the fixed
`.jax_cache` directory at the root of the checkout (listed in
.gitignore): a cache directory that moves between runs never hits.
Opt out with RT_NO_COMPILE_CACHE=1. Safe to call multiple times.
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(_REPO, ".jax_cache")


def enable_compilation_cache() -> str | None:
    """Point jax at a persistent on-disk compilation cache; returns the
    directory (or None when disabled)."""
    if os.environ.get("RT_NO_COMPILE_CACHE"):
        return None
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache every compile that matters (sub-half-second programs
    # recompile faster than a cache probe) and never skip an entry for
    # its size.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
