"""Multi-host runtime (component D5).

No reference counterpart (single-process crate). This module wires the
framework to multi-host clusters the JAX way: ``jax.distributed.initialize``
for process bootstrap, per-host row-block construction so each host builds
only its slice of a giant CSR, a global mesh spanning all hosts, and
``jax.make_array_from_single_device_arrays`` assembly so no host ever
materialises the full matrix.

Single-host environments (including the CI CPU mesh) run everything
unchanged with ``num_processes == 1`` — the per-host construction path is
exercised by tests there; real multi-host runs only add the
``initialize()`` call per process.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.csr import CSR
from .mesh import ROWS
from .sharded import ShardedCSR, shard_csr


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bootstrap multi-host JAX. No-op when running single-process (all
    arguments None and no cluster env detected)."""
    if (coordinator_address is None and num_processes is None
            and jax.process_count() == 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_row_mesh() -> Mesh:
    """1D ``rows`` mesh over every device of every host."""
    return Mesh(np.asarray(jax.devices()), axis_names=(ROWS,))


@dataclasses.dataclass(frozen=True)
class RowBlockSpec:
    """Which global rows this host owns."""

    row_start: int
    row_end: int
    global_rows: int
    global_cols: int


def local_row_block(global_rows: int, global_cols: int,
                    process_id: Optional[int] = None,
                    process_count: Optional[int] = None) -> RowBlockSpec:
    """Contiguous equal row block for this host."""
    pid = jax.process_index() if process_id is None else process_id
    pc = jax.process_count() if process_count is None else process_count
    per = -(-global_rows // pc)
    return RowBlockSpec(
        row_start=min(pid * per, global_rows),
        row_end=min((pid + 1) * per, global_rows),
        global_rows=global_rows,
        global_cols=global_cols,
    )


def build_global_sharded_csr(
    spec: RowBlockSpec,
    local_builder: Callable[[RowBlockSpec], CSR],
    mesh: Optional[Mesh] = None,
    nnz_max_per_device: Optional[int] = None,
) -> ShardedCSR:
    """Assemble a globally-sharded CSR where each host contributes only its
    own row block (built by ``local_builder``, which receives the block spec
    and returns a local CSR of shape (row_end-row_start, global_cols)).

    Per-device padding must be uniform across the global array, so
    ``nnz_max_per_device`` (a global agreement, e.g. from the generator's
    analytic bound) is required on real multi-host runs; single-process runs
    can omit it and use the observed local maximum.
    """
    mesh = mesh or global_row_mesh()
    local = local_builder(spec)
    n_local_dev = max(jax.local_device_count(), 1)
    sa_local = shard_csr(local, n_local_dev)
    if nnz_max_per_device is not None:
        pad = nnz_max_per_device - sa_local.indices.shape[1]
        if pad < 0:
            raise ValueError(
                f"nnz_max_per_device {nnz_max_per_device} below observed "
                f"{sa_local.indices.shape[1]}"
            )
        if pad:
            # Padding entries live in the last local row with value 0.
            sa_local = ShardedCSR(
                indptr=sa_local.indptr.at[:, -1].add(pad),
                indices=jnp.pad(sa_local.indices, ((0, 0), (0, pad))),
                values=jnp.pad(sa_local.values, ((0, 0), (0, pad))),
                rows=sa_local.rows,
                cols=sa_local.cols,
                rows_per_shard=sa_local.rows_per_shard,
            )

    if jax.process_count() == 1:
        from .sharded import put_sharded

        return put_sharded(sa_local, mesh)

    # Multi-host: assemble global arrays from per-host single-device shards.
    sharding = NamedSharding(mesh, P(ROWS))
    n_global_dev = len(jax.devices())

    def assemble(local_stacked):
        shape = (n_global_dev,) + tuple(local_stacked.shape[1:])
        # each per-device piece keeps its leading shard axis of size 1
        locals_ = [
            jax.device_put(local_stacked[i:i + 1], d)
            for i, d in enumerate(jax.local_devices())
        ]
        return jax.make_array_from_single_device_arrays(
            shape, sharding, locals_)

    return ShardedCSR(
        indptr=assemble(sa_local.indptr),
        indices=assemble(sa_local.indices),
        values=assemble(sa_local.values),
        rows=spec.global_rows,
        cols=spec.global_cols,
        rows_per_shard=sa_local.rows_per_shard,
    )


def weak_scaling_report(seconds: float, nnz_per_host: int,
                        baseline_seconds_1host: float) -> dict:
    """Weak-scaling efficiency record (BASELINE.md: ≥80% at ≥2 hosts)."""
    hosts = jax.process_count()
    eff = baseline_seconds_1host / seconds if seconds else 0.0
    return {
        "hosts": hosts,
        "nnz_total": nnz_per_host * hosts,
        "seconds": seconds,
        "weak_scaling_efficiency": eff,
    }
