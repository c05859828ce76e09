"""Distributed conjugate-gradient solver — the scalable iterative
counterpart to the reference's direct Cholesky ``solve`` (lib.rs:11-24).

The whole iteration runs inside one ``shard_map``: each device applies its
row block of A to the (replicated) search direction, an ``all_gather``
re-assembles the matvec, and scalars (dot products) are computed
redundantly on every device from replicated vectors — no psum needed. One jit
compilation covers the full ``lax.fori_loop``; this is the "training step" of
the multichip dry run (``__graft_entry__.dryrun_multichip``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .mesh import ROWS
from .sharded import ShardedCSR
from .spmm import _local_spmv


def cg_solve_sharded(
    sa: ShardedCSR, b: jax.Array, mesh, iters: int = 50, tol: float = 0.0
) -> jax.Array:
    """Solve ``A x = b`` (SPD, row-sharded A) by CG. ``b`` replicated,
    padded-row tail must be zero; returns replicated x of length
    ``padded_rows``."""
    pr = sa.padded_rows
    b_padded = jnp.pad(b.astype(jnp.float32), (0, pr - b.shape[0]))

    def body(indptr, indices, values, b_full):
        indptr, indices, values = indptr[0], indices[0], values[0]

        def matvec(x):
            local = _local_spmv(sa, indptr, indices,
                                values.astype(jnp.float32), x)
            return jax.lax.all_gather(local, ROWS, tiled=True)

        # Loop carries become device-varying through the all_gather matvec;
        # mark initial values accordingly (jax>=0.9 shard_map vma check).
        var = lambda v: jax.lax.pcast(v, ROWS, to="varying")
        x0 = var(jnp.zeros_like(b_full))
        r0 = var(b_full)
        p0 = var(b_full)
        rr0 = var(jnp.vdot(b_full, b_full))

        def step(_, carry):
            x, r, p, rr = carry
            ap = matvec(p)
            alpha = rr / jnp.maximum(jnp.vdot(p, ap), 1e-30)
            x = x + alpha * p
            r = r - alpha * ap
            rr_new = jnp.vdot(r, r)
            beta = rr_new / jnp.maximum(rr, 1e-30)
            p = r + beta * p
            return x, r, p, rr_new

        x, r, p, rr = jax.lax.fori_loop(0, iters, step, (x0, r0, p0, rr0))
        # x is identical on every device but flagged varying (it flowed
        # through all_gather); return each device's own row block and let the
        # P("rows") out_spec reassemble the full vector.
        me = jax.lax.axis_index(ROWS)
        rps = sa.rows_per_shard
        return jax.lax.dynamic_slice_in_dim(x, me * rps, rps)

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROWS), P(ROWS), P(ROWS), P()),
        out_specs=P(ROWS),
    )
    return jax.jit(f)(sa.indptr, sa.indices, sa.values, b_padded)
