"""Persistent XLA compile cache shared by every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it. Otherwise the cache lives at a fixed path inside the
checkout (``<repo>/.jax_cache``, listed in ``.gitignore``): the directory
is part of the cache key, so a fixed path is what lets one run reuse the
programs another compiled.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")

# Low enough that every train-step and render program is cached, high
# enough that the many tiny host-side helper programs are not.
MIN_COMPILE_TIME_S = 0.5


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory. Call
    before the first compilation."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", MIN_COMPILE_TIME_S
    )
    return DEFAULT_DIR
