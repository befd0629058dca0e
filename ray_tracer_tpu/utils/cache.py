"""Where JAX's persistent compilation cache lives.

Every entry point (CLI, bench, chip smoke, tests) calls
`use_compile_cache()` before its first compile, so they all share one
cache.
"""

from __future__ import annotations

import os

import jax

# One fixed path inside the checkout (listed in .gitignore): the cache
# is only found again at the same path, so it is never built from a
# temporary name, a pid or the time.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX already keeps its cache
    there and nothing is changed; otherwise the cache goes to CACHE_DIR.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
