"""JAX's persistent compilation cache, kept at one fixed place.

A cold process spends most of its start-up compiling the fused encoder, so
scripts that run on the device (``bench.py``, ``chip_smoke.py``) keep the
compiled programs across runs.  The cache directory is part of what makes a
later run find an entry, so it never moves: ``JAX_COMPILATION_CACHE_DIR``
when the environment sets it (JAX reads that variable itself), otherwise
``.jax_cache`` at the root of the checkout.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its fixed directory; return the path.

    Call before the first compile.  With ``JAX_COMPILATION_CACHE_DIR`` set
    nothing is changed; otherwise the cache directory is
    :data:`REPO_CACHE_DIR`.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
