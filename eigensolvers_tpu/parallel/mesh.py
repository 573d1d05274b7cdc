"""Device-mesh construction and multi-host initialization.

This is the framework's distributed-communication layer — the component the
reference lacks entirely (its only trace is an inert MPI import,
SURVEY.md §2.4): XLA collectives across devices (NVLink within a host)
replace MPI, driven by shardings on a ``jax.sharding.Mesh``.

Mesh convention used throughout:
  * axis ``"x"`` — the state-vector dimension (the scale axis: n can be a
    product of mode dimensions far beyond one chip's HBM);
  * axis ``"b"`` — the embarrassingly-parallel batch of shifted solves
    (FEAST quadrature nodes × subspace vectors, Lanczos block vectors).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(batch: int = 1, shard: Optional[int] = None,
              devices=None) -> Mesh:
    """Build a ("b", "x") mesh: ``batch`` lanes of solve-parallelism ×
    ``shard``-way vector sharding.  Defaults to all available devices in one
    "x" row."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shard is None:
        assert n % batch == 0, f"{n} devices not divisible by batch={batch}"
        shard = n // batch
    assert batch * shard <= n, f"mesh {batch}x{shard} > {n} devices"
    dev_grid = np.array(devices[:batch * shard]).reshape(batch, shard)
    return Mesh(dev_grid, axis_names=("b", "x"))


def distributed_initialize(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None):
    """Multi-host bring-up (one JAX process per host).  Thin wrapper so drivers never import jax.distributed
    directly; no-op when running single-process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def vector_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Shard a state vector/tensor over its first axis on mesh axis "x"."""
    return NamedSharding(mesh, P(*(("x",) + (None,) * (ndim - 1))))


def batched_vector_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """(batch, n, ...) arrays: batch over "b", vector dim over "x"."""
    return NamedSharding(mesh, P(*(("b", "x") + (None,) * (ndim - 1))))


def operator_row_sharding(mesh: Mesh) -> NamedSharding:
    """Row-partition an (n, n) operator over mesh axis "x": each device owns
    a block of rows; the matvec all-gathers x and keeps the product
    row-sharded (SURVEY.md §2.4 item 1)."""
    return NamedSharding(mesh, P("x", None))
