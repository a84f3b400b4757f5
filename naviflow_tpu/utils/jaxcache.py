"""Persistent XLA compilation cache setup.

Each distinct solver configuration compiles one large program (the whole
outer loop with its multigrid hierarchy), so the persistent cache turns that
into a once-per-checkout cost instead of a once-per-process one.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory.  Otherwise the cache lives at the fixed path
``<checkout>/.jax_cache`` (listed in ``.gitignore``): the directory is part
of what a later process must find again, so it depends on nothing but the
checkout — not the host, the process or the time.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def enable_persistent_cache() -> str:
    """Turn the persistent compilation cache on and return its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
