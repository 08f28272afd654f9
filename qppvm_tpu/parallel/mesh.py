"""Device-mesh and sharding helpers (SURVEY.md §2c).

The reference is single-robot single-thread (no DP/TP/PP, no NCCL/MPI —
verified in SURVEY.md §2c); the parallel dimensions here are greenfield,
designed for the BASELINE north star: batch MPC rollouts sharded over a
``rollout`` mesh axis (DP over scenarios), cost reductions via XLA
collectives over NVLink, multi-host bootstrap via ``jax.distributed``.

Design decisions recorded per SURVEY.md §2c:
- TP/PP: not used — per-rollout WBC matrices are 30-60 wide; a whole QP stays
  resident on one chip, scale-out is across rollouts.
- Horizon (SP analog): ``lax.scan`` per rollout; ring-sharding of the horizon
  via ``ppermute`` is the documented growth path if horizons outgrow a chip.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "rollout") -> Mesh:
    """1-D mesh over available (or the first n) devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def make_2d_mesh(shape: Sequence[int], axes=("host", "rollout")) -> Mesh:
    devs = np.asarray(jax.devices()[: int(np.prod(shape))]).reshape(tuple(shape))
    return Mesh(devs, tuple(axes))


def shard_batch(tree, mesh: Mesh, axis: str = "rollout"):
    """Shard the leading (batch) axis of every leaf over ``axis``."""
    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(put, tree)


def replicate(tree, mesh: Mesh):
    def put(x):
        return jax.device_put(x, NamedSharding(mesh, P()))
    return jax.tree.map(put, tree)


def batch_spec(mesh: Mesh, axis: str = "rollout"):
    return NamedSharding(mesh, P(axis))


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """DCN bootstrap for multi-host runs (jax.distributed.initialize).
    No-op when single-process (the common bench path)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
