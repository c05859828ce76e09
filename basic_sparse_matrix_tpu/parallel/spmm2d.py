"""2D-mesh SpMM: rows of A over the ``"rows"`` axis, RHS columns over the
``"cols"`` axis (multi-RHS data parallelism), with the K panels ring-rotated
like :func:`parallel.spmm.spmm_ring`.

This is the full sharding story for the flagship op: tensor parallelism over
matrix rows × data parallelism over RHS columns × ring-pipelined K panels.
Exercised by ``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .mesh import COLS, ROWS
from .sharded import ShardedCSR
from .spmm import _local_row_ids, _pad_k


def spmm_ring_2d(sa: ShardedCSR, b: jax.Array, mesh) -> jax.Array:
    num = sa.num_shards
    b_padded = _pad_k(b, num)
    kps = b_padded.shape[0] // num
    n_cols_axis = mesh.shape[COLS]
    n = b.shape[1]
    n_pad = -(-n // n_cols_axis) * n_cols_axis - n
    b_padded = jnp.pad(b_padded, ((0, 0), (0, n_pad)))

    def body(indptr, indices, values, b_loc):
        indptr, indices, values = indptr[0], indices[0], values[0]
        b_buf = b_loc[0]  # (kps, N / n_cols_axis)
        me = jax.lax.axis_index(ROWS)
        rps = sa.rows_per_shard
        row_ids = _local_row_ids(indptr, rps, values.shape[0])
        acc = jax.lax.pcast(
            jnp.zeros((rps, b_buf.shape[1]), dtype=b_buf.dtype),
            (ROWS, COLS), to="varying",
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
            b_buf = jax.lax.ppermute(b_buf, ROWS, perm)
            return acc, b_buf

        acc, _ = jax.lax.fori_loop(0, num, step, (acc, b_buf))
        return acc

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROWS), P(ROWS), P(ROWS), P(ROWS, None, COLS)),
        out_specs=P(ROWS, COLS),
    )
    out = jax.jit(f)(
        sa.indptr, sa.indices, sa.values,
        b_padded.reshape(num, kps, b_padded.shape[1]),
    )
    return out[:, :n]
