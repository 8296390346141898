"""Persistent XLA compile cache placement for the entry points.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it at import and this
module sets nothing. Otherwise the cache goes to ``<repo>/.jax_cache``
(listed in ``.gitignore``). Called from the CLI, ``bench.py`` and
``chip_smoke.py`` — never at package import, so library users keep
control of their own JAX configuration.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
