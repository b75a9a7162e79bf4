"""Persistent XLA compilation cache.

Every new process pays the first compile of each scan geometry again. JAX
ships a persistent compilation cache (serialized XLA executables keyed by
HLO + compile options + platform); this module wires it into scanner
construction so the SECOND process of a serving fleet reads executables
from disk instead of recompiling.

Policy:
* enabled automatically by DenseScanner/ShardedScanner construction (once
  per process);
* opt-out: ``ACX_COMPILE_CACHE=off`` in the environment, or
  ``enable_compile_cache(enabled=False)`` before building a scanner;
* cache directory, first match wins:
  1. ``JAX_COMPILATION_CACHE_DIR`` — JAX reads it itself, and this module
     then sets no directory of its own;
  2. the ``path`` argument of an explicit ``enable_compile_cache(path)``;
  3. ``ACX_COMPILE_CACHE`` when it holds a path;
  4. ``<checkout>/.jax_cache`` — a fixed path (the path is part of what
     makes a later process find the entries), git-ignored;
* only compilations taking >= 1 s persist (the big scan kernels; tiny
  host-side jits stay out of the cache).

An explicit ``enable_compile_cache(path)`` takes effect whenever it is
called, also after the automatic call at scanner construction.

The reference has no analogue (it has no compiler); anchor: machine
construction cost discussion, reference README.md:358-368.
"""

from __future__ import annotations

import os

_ENV_DIR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_auto_done = False
_active: str | None = None   # the directory ACTUALLY in use, if any


def enable_compile_cache(path: str | None = None,
                         enabled: bool = True) -> str | None:
    """Enable JAX's persistent compilation cache. Returns the cache
    directory ACTUALLY in use, or None when disabled. Without arguments
    (the scanners' call) it runs once per process and repeat calls report
    the first outcome; an explicit ``path`` or ``enabled=False`` always
    applies. Must run before the first compilation it should capture.
    Never raises: an unwritable cache directory degrades to cache-off
    (scanner construction must not fail because the checkout is
    read-only)."""
    global _auto_done, _active
    explicit = path is not None or not enabled
    if not explicit and _auto_done:
        return _active
    _auto_done = True
    import jax
    from jax.experimental.compilation_cache import compilation_cache
    if not enabled or not _enabled():
        if _active is not None and not os.environ.get(_ENV_DIR):
            compilation_cache.reset_cache()
            jax.config.update("jax_compilation_cache_dir", None)
        _active = None
        return None

    env = os.environ.get(_ENV_DIR)
    d = env or path or _cache_dir()
    try:
        os.makedirs(d, exist_ok=True)
        if not env and d != jax.config.jax_compilation_cache_dir:
            compilation_cache.reset_cache()
            compilation_cache.set_cache_dir(d)
        # Persist anything that took real compile time; leave the many
        # tiny host-side jits (decode helpers, probes) out of the cache.
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    except OSError:
        _active = None
        return None
    _active = d
    return d


def _enabled() -> bool:
    return os.environ.get("ACX_COMPILE_CACHE", "").lower() not in (
        "off", "0", "no", "false")


def _cache_dir() -> str:
    v = os.environ.get("ACX_COMPILE_CACHE", "")
    if v and v.lower() not in ("on", "1", "yes", "true"):
        return os.path.expanduser(v)
    return DEFAULT_DIR
