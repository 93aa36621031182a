"""Where this repository's programs keep XLA's persistent compile cache.

The test suite, bench.py and chip_smoke.py call :func:`enable` at start-up;
the library itself never sets a cache.  When ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX already uses that directory and nothing else is set; otherwise the
cache lives at the fixed ``<repo>/.jax_cache`` (gitignored), so it is found
again by the next run from the same checkout.
"""

from __future__ import annotations

import os
import pathlib
from typing import Mapping, Optional

REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The directory the cache lives in for this environment."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or str(REPO_CACHE_DIR)


def enable(environ: Optional[Mapping[str, str]] = None) -> str:
    """Point JAX's persistent compile cache at :func:`cache_dir` and return
    it.  Must run before the first compilation."""
    import jax

    environ = os.environ if environ is None else environ
    if not environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    # Also cache the many sub-second CPU compiles of the test suite.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return cache_dir(environ)
