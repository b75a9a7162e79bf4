"""Device mesh helpers.

The reference has no distributed dimension at all (SURVEY.md §2c) — its only
concurrency is a process-local mutex (aho_corasick.c:81). Here the corpus is
sharded data-parallel over a 1-D ``jax.sharding.Mesh`` ("data" axis), the
automaton tables are replicated per chip, and match reductions ride XLA
collectives (NCCL on GPUs). A 1-D mesh is the right shape for this workload:
the automaton is small and replicated (no tensor/pipeline dimension), so all
devices — across hosts too — form one data axis.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

DATA_AXIS = "data"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    """1-D data-parallel mesh over the first ``n_devices`` devices
    (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} present")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up: initialize jax.distributed so jax.devices()
    spans every host's devices. Pass the coordinator address (e.g.
    ``localhost:<port>``), the process count and this process's id where
    nothing in the environment tells JAX of the cluster; call once before
    make_mesh().

    The scan path needs no further multi-host awareness: shard_map +
    NamedSharding place data by device order, the halo ppermute touches
    only neighbor devices, and psum is a scalar — see SURVEY.md §2c.
    """
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def data_sharded(mesh: Mesh, axis_name: str = DATA_AXIS) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(axis_name))
