"""Device-mesh construction helpers.

The reference has no distribution layer — SURVEY.md section 2b/5.8: it is
a single-process CPU program (OpenMP + Ceres threads); here scaling is
`jax.sharding.Mesh` axes:

    'points'  — residual-block sharding (the TP-analog): the point table and
                all (N, ...) tensors are sharded; the Schur reduction is a
                single psum over this axis (NVLink between the cards of
                one host).
    'windows' — window/sequence data-parallelism (the DP-analog): independent
                sliding windows solved concurrently.

Multi-process: `initialize_distributed` then the same mesh spans processes.
No hand-written transport — XLA collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(points: int = 1, windows: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('windows', 'points') mesh over the given (or all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    need = points * windows
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(windows, points)
    return Mesh(arr, axis_names=("windows", "points"))


def points_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("points"))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[Sequence[int]] = None):
    """Multi-process bring-up (jax.distributed). Safe no-op for one process.

    `local_device_ids` are the cards this process opens; the default is one
    card per process, card `process_id` — the layout of several processes
    on one host. A JAX process reserves most of every card it opens, so a
    process must never open its neighbours' cards."""
    if num_processes is None or num_processes <= 1:
        return
    if local_device_ids is None:
        local_device_ids = [process_id]
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=list(local_device_ids))
