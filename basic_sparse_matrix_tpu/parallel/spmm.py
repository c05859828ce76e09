"""Distributed SpMM / SpMV over a device mesh (components D2 of SURVEY.md §2).

Collective strategies, all built on ``jax.shard_map`` so XLA schedules the
collectives (NCCL on GPUs) and overlaps them with per-block compute:

* :func:`spmv_sharded` / :func:`spmm_sharded` — A row-sharded, operand
  replicated: zero communication; output row-sharded. The baseline layout.
  :func:`spmm_sharded_ell` is the same layout over ELL shards (gather+FMA,
  no scatter), the path ``DistributedOperator.matmul`` takes for rows of
  bounded length.
* :func:`spmm_allgather` — A row-sharded, B row-(K-)sharded: one
  ``all_gather`` of B's row panels, then local SpMM.
* :func:`spmm_ring` — A row-sharded, B K-sharded: a ``ppermute`` ring rotates
  B's panels neighbour-to-neighbour; each step multiplies the local column
  block against the panel in flight. Peak memory stays at one panel per
  device and XLA overlaps the permute with the current block's compute — the
  ring-attention-shaped dataflow applied to SpMM (SURVEY.md §5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .mesh import ROWS
from .sharded import ShardedCSR


def _local_row_ids(indptr: jax.Array, rps: int, nnz: int) -> jax.Array:
    return jnp.repeat(
        jnp.arange(rps, dtype=jnp.int32), jnp.diff(indptr),
        total_repeat_length=nnz,
    )


def _local_spmv(sa: ShardedCSR, indptr, indices, values, x):
    rps = sa.rows_per_shard
    prod = values * x[indices]
    return jax.ops.segment_sum(
        prod, _local_row_ids(indptr, rps, values.shape[0]),
        num_segments=rps, indices_are_sorted=True,
    )


def _local_spmm(sa: ShardedCSR, indptr, indices, values, b):
    rps = sa.rows_per_shard
    gathered = b[indices] * values[:, None]
    return jax.ops.segment_sum(
        gathered, _local_row_ids(indptr, rps, values.shape[0]),
        num_segments=rps, indices_are_sorted=True,
    )


def spmv_sharded(sa: ShardedCSR, x: jax.Array, mesh) -> jax.Array:
    """Row-sharded SpMV with a replicated operand vector. Output is
    row-sharded of length ``padded_rows`` (trim with ``unshard_rows``)."""

    def body(indptr, indices, values, x):
        return _local_spmv(sa, indptr[0], indices[0], values[0], x)

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROWS), P(ROWS), P(ROWS), P()),
        out_specs=P(ROWS),
    )
    return jax.jit(f)(sa.indptr, sa.indices, sa.values, x)


def spmm_sharded(sa: ShardedCSR, b: jax.Array, mesh) -> jax.Array:
    """Row-sharded SpMM with replicated dense RHS."""

    def body(indptr, indices, values, b):
        return _local_spmm(sa, indptr[0], indices[0], values[0], b)

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROWS), P(ROWS), P(ROWS), P()),
        out_specs=P(ROWS),
    )
    return jax.jit(f)(sa.indptr, sa.indices, sa.values, b)


def _pad_k(b: jax.Array, num_shards: int) -> jax.Array:
    k = b.shape[0]
    kps = -(-k // num_shards)
    return jnp.pad(b, ((0, kps * num_shards - k),) + ((0, 0),) * (b.ndim - 1))


def spmm_allgather(sa: ShardedCSR, b: jax.Array, mesh) -> jax.Array:
    """B stored K-sharded; one tiled all-gather re-assembles the panels on
    each device, then local SpMM."""
    num = sa.num_shards
    b_padded = _pad_k(b, num)

    def body(indptr, indices, values, b_loc):
        b_full = jax.lax.all_gather(b_loc[0], ROWS, tiled=True)
        return _local_spmm(sa, indptr[0], indices[0], values[0],
                           b_full[: sa.cols])

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROWS), P(ROWS), P(ROWS), P(ROWS)),
        out_specs=P(ROWS),
    )
    return jax.jit(f)(
        sa.indptr, sa.indices, sa.values,
        b_padded.reshape(num, -1, *b.shape[1:]),
    )


def spmm_ring(sa: ShardedCSR, b: jax.Array, mesh) -> jax.Array:
    """B K-sharded; panels rotate around a ``ppermute`` ring while each
    device multiplies its local column block against the panel it currently
    holds. Memory: one panel; comms overlap with compute."""
    num = sa.num_shards
    b_padded = _pad_k(b, num)
    kps = b_padded.shape[0] // num

    def body(indptr, indices, values, b_loc):
        indptr, indices, values = indptr[0], indices[0], values[0]
        b_buf = b_loc[0]  # (kps, N)
        me = jax.lax.axis_index(ROWS)
        rps = sa.rows_per_shard
        row_ids = _local_row_ids(indptr, rps, values.shape[0])
        # fori_loop carries become device-varying after the first ppermute;
        # mark the initial values accordingly (jax>=0.9 shard_map vma check).
        acc = jax.lax.pcast(
            jnp.zeros((rps, b_buf.shape[1]), dtype=b_buf.dtype),
            ROWS, to="varying",
        )
        perm = [(i, (i - 1) % num) for i in range(num)]

        def step(t, carry):
            acc, b_buf = carry
            owner = (me + t) % num
            k0 = owner * kps
            local_idx = indices - k0
            valid = (local_idx >= 0) & (local_idx < kps)
            safe_idx = jnp.clip(local_idx, 0, kps - 1)
            contrib = jnp.where(
                valid[:, None], values[:, None] * b_buf[safe_idx], 0.0
            )
            acc = acc + jax.ops.segment_sum(
                contrib, row_ids, num_segments=rps, indices_are_sorted=True
            )
            # Rotate the panel to the left neighbour for the next step; XLA
            # overlaps this transfer with the next step's compute.
            b_buf = jax.lax.ppermute(b_buf, ROWS, perm)
            return acc, b_buf

        acc, _ = jax.lax.fori_loop(0, num, step, (acc, b_buf))
        return acc

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROWS), P(ROWS), P(ROWS), P(ROWS)),
        out_specs=P(ROWS),
    )
    return jax.jit(f)(
        sa.indptr, sa.indices, sa.values,
        b_padded.reshape(num, kps, *b.shape[1:]),
    )


def shard_ell(a, mesh):
    """Host CSR → ELL with rows padded to the mesh and each row block put
    straight onto its device (never staged whole on one device)."""
    from jax.sharding import NamedSharding

    from ..ops.ell import ELL, ell_host_arrays

    cols, vals = ell_host_arrays(a, pad_rows_to=mesh.shape[ROWS])
    spec = NamedSharding(mesh, P(ROWS))
    return ELL(cols=jax.device_put(cols, spec),
               vals=jax.device_put(vals, spec), n_cols=a.cols)


def spmm_sharded_ell(ell, b: jax.Array, mesh) -> jax.Array:
    """Row-sharded SpMM over an ELL operand with replicated RHS — the
    gather/reduce formulation (no scatter) distributed by sharding the
    rectangular (rows, width) arrays over the ``rows`` axis; each device
    runs the single-device :func:`ops.ell.spmm_ell` on its block. Returns
    the row-sharded product of shape (padded rows, n_rhs)."""
    from ..ops.ell import ELL, spmm_ell

    num = mesh.shape[ROWS]
    rows = ell.cols.shape[0]
    pad = (-rows) % num
    cols = jnp.pad(ell.cols, ((0, pad), (0, 0))) if pad else ell.cols
    vals = jnp.pad(ell.vals, ((0, pad), (0, 0))) if pad else ell.vals

    def body(c, v, b):
        return spmm_ell(ELL(cols=c, vals=v, n_cols=ell.n_cols), b)

    # check_vma=False: on the GPU the body is a Pallas kernel, whose output
    # shape carries no record of the mesh axes its inputs vary over.
    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROWS), P(ROWS), P()),
        out_specs=P(ROWS), check_vma=False,
    )
    return jax.jit(f)(cols, vals, b)
