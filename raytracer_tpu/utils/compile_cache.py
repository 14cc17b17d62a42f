"""Where the persistent XLA compile cache lives.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here.  Otherwise the cache goes to the fixed path ``<checkout>/.jax_cache``
(listed in .gitignore): a cache entry is only found again under the same
directory, so the path must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_DIR = CHECKOUT / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it.
    Call before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
