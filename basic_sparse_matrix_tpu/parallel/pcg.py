"""Distributed preconditioned CG: block-Jacobi with per-device dense
Cholesky blocks.

The single-chip iterative solver pairs CG with an IC(0) preconditioner
(``models/pcg.py``); its distributed analogue here uses the classic
communication-free preconditioner for row-partitioned matrices —
**block-Jacobi**: every device factors its own diagonal block ``A_ss``
(dense Cholesky, built once) and applies two local triangular
solves per iteration. The preconditioner application needs *zero*
collectives; the only communication per CG step stays the one
``all_gather`` of the matvec, so the iteration profile is identical to
:func:`~basic_sparse_matrix_tpu.parallel.cg.cg_solve_sharded` while the
iteration count drops like a Jacobi-Schwarz method.

No reference counterpart (the reference's only solver is the sequential
dense-logic Cholesky pipeline, ``/root/reference/src/lib.rs:11-24``); this is
the D2/D4 scalable-iterative entry of SURVEY.md §2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..utils.config import factor_precision
from .mesh import ROWS
from .sharded import ShardedCSR
from .spmm import _local_row_ids, _local_spmv


def _local_diag_block(sa: ShardedCSR, indptr, indices, values):
    """Densify this device's diagonal block ``A[s*rps:(s+1)*rps, same]``.

    Entries outside the local column range are masked to zero (they belong
    to off-diagonal blocks); rows without a diagonal entry (row padding from
    the equal-block partition) get a unit diagonal so the block stays SPD.
    """
    rps = sa.rows_per_shard
    me = jax.lax.axis_index(ROWS)
    nnz = values.shape[0]
    rowid = _local_row_ids(indptr, rps, nnz)
    col_local = indices - me * rps
    in_block = jnp.logical_and(col_local >= 0, col_local < rps)
    val = jnp.where(in_block, values.astype(jnp.float32), 0.0)
    col_clip = jnp.clip(col_local, 0, rps - 1)
    block = jnp.zeros((rps, rps), jnp.float32).at[rowid, col_clip].add(val)
    diag = jnp.diagonal(block)
    return block + jnp.diag(jnp.where(diag == 0.0, 1.0, 0.0))


def build_block_jacobi(sa: ShardedCSR, mesh) -> jax.Array:
    """Factor every diagonal block once: returns the stacked lower Cholesky
    factors ``(num_shards, rps, rps)``, sharded over the ``rows`` axis, for
    :func:`pcg_solve_sharded`'s ``lfac`` argument."""

    def body(indptr, indices, values):
        block = _local_diag_block(sa, indptr[0], indices[0], values[0])
        with factor_precision():
            return jnp.linalg.cholesky(block)[None]

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROWS), P(ROWS), P(ROWS)),
        out_specs=P(ROWS),
    )
    return jax.jit(f)(sa.indptr, sa.indices, sa.values)


def pcg_solve_sharded(
    sa: ShardedCSR, b: jax.Array, mesh, iters: int = 50,
    lfac: jax.Array | None = None,
) -> jax.Array:
    """Solve ``A x = b`` (SPD, row-sharded A) by block-Jacobi PCG.

    ``b`` replicated; returns replicated x of length ``padded_rows`` (trim
    with ``unshard_rows``). Pass a prebuilt ``lfac`` from
    :func:`build_block_jacobi` to amortise the block factorization across
    solves (the serving pattern); otherwise it is built internally.
    """
    if lfac is None:
        lfac = build_block_jacobi(sa, mesh)
    pr = sa.padded_rows
    rps = sa.rows_per_shard
    b_padded = jnp.pad(b.astype(jnp.float32), (0, pr - b.shape[0]))

    def body(indptr, indices, values, lfac, b_full):
        indptr, indices, values = indptr[0], indices[0], values[0]
        l = lfac[0]
        me = jax.lax.axis_index(ROWS)

        def matvec(x):
            local = _local_spmv(sa, indptr, indices,
                                values.astype(jnp.float32), x)
            return jax.lax.all_gather(local, ROWS, tiled=True)

        def apply_m_inv(r):
            r_local = jax.lax.dynamic_slice_in_dim(r, me * rps, rps)
            with factor_precision():
                y = jax.scipy.linalg.solve_triangular(l, r_local,
                                                      lower=True)
                z_local = jax.scipy.linalg.solve_triangular(
                    l, y, lower=True, trans=1)
            return jax.lax.all_gather(z_local, ROWS, tiled=True)

        var = lambda v: jax.lax.pcast(v, ROWS, to="varying")
        r0 = var(b_full)
        z0 = apply_m_inv(r0)
        x0 = var(jnp.zeros_like(b_full))
        rz0 = jnp.vdot(r0, z0)

        def step(_, carry):
            x, r, p, rz = carry
            ap = matvec(p)
            alpha = rz / jnp.maximum(jnp.vdot(p, ap), 1e-30)
            x = x + alpha * p
            r = r - alpha * ap
            z = apply_m_inv(r)
            rz_new = jnp.vdot(r, z)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            p = z + beta * p
            return x, r, p, rz_new

        x, r, p, rz = jax.lax.fori_loop(0, iters, step, (x0, r0, z0, rz0))
        return jax.lax.dynamic_slice_in_dim(x, me * rps, rps)

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROWS), P(ROWS), P(ROWS), P(ROWS), P()),
        out_specs=P(ROWS),
    )
    return jax.jit(f)(sa.indptr, sa.indices, sa.values, lfac, b_padded)
