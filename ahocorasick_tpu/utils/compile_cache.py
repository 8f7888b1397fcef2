"""Where JAX keeps its persistent compilation cache for this checkout.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
lives at one fixed path inside the checkout (``.jax_cache``, git-ignored),
so repeated runs of the tests, the bench and ``chip_smoke.py`` find their
compiled programs again.  Call ``configure()`` before JAX is imported.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def configure() -> str:
    """Point JAX's persistent cache at its directory; returns the path."""
    path = os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", DEFAULT_DIR)
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
    return path
