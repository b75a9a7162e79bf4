"""Test rig: force a CPU backend with 8 virtual devices so multi-chip
sharding tests (parallel/) run without accelerators — the fake-mesh
strategy the reference never needed (SURVEY.md §4, last bullet).

``jax.config.update("jax_platforms", "cpu")`` runs at conftest import time,
before any backend initialization, so the suite stays on the CPU even on a
machine with a GPU (where JAX would otherwise pick the GPU). Tests that
need the card carry the ``gpu`` marker and skip here; ``chip_smoke.py``
covers that path on the card.
"""

import os

# The native debug hook (acx_debug_set_counts) is runtime-gated: inert in
# production processes, live only under this opt-in (ADVICE r4).
os.environ.setdefault("ACX_TESTING", "1")

# Keep the suite hermetic: no persistent XLA cache writes from tests
# (utils/compile_cache.py; the cache's own test monkeypatches this).
os.environ.setdefault("ACX_COMPILE_CACHE", "off")

if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
