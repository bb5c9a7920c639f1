"""Where compiled XLA programs are kept between processes.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, nothing
here overrides it. Otherwise the cache goes to ``<repo>/.jax_cache``: a
fixed path, because the directory is part of the cache's key, so a
directory that moves between runs never hits.
"""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE
