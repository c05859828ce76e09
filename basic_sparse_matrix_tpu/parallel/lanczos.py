"""Distributed Lanczos eigensolver over the device mesh.

The mesh-scale counterpart of ``models/lanczos.py`` (which itself serves
the regime the reference's dense QR iteration, ``/root/reference/src/
sparse.rs:758-774``, cannot reach). A row-sharded SPD matrix too large for
one chip still yields its extremal spectrum: per step ONE local SpMV +
``all_gather`` (identical comm pattern to ``parallel/cg.py``),
while the Krylov basis is **row-sharded** — each device stores only
``(k, rows/ndev)`` — and full reorthogonalisation runs as local
``(k, rps)`` matmuls with one ``psum`` of the k Gram-Schmidt coefficients.
Per-step comm: one tiled all_gather of a length-n vector + two psums of a
length-k vector; per-device memory O(k·n/ndev).

The whole k-step build is one ``lax.scan`` inside one ``shard_map`` —
a single compiled program.
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


@functools.partial(jax.jit, static_argnums=(2, 3), static_argnames=("n",))
def _lanczos_sharded_jit(sa: ShardedCSR, v0: jax.Array, k: int, mesh, *,
                         n: int):
    pr = sa.padded_rows
    rps = sa.rows_per_shard
    eps = jnp.float32(1e-7)
    # Basis/restart vectors must keep the padded tail zero so the padded
    # (zero) rows of A never enter the Krylov space.
    live = (jnp.arange(pr) < n).astype(jnp.float32)

    def body(indptr, indices, values, v0_full):
        indptr, indices, values = indptr[0], indices[0], values[0]
        me = jax.lax.axis_index(ROWS)

        def myslice(x_full):
            return jax.lax.dynamic_slice_in_dim(x_full, me * rps, rps)

        def matvec(x_full):
            local = _local_spmv(sa, indptr, indices,
                                values.astype(jnp.float32), x_full)
            return jax.lax.all_gather(local, ROWS, tiled=True)

        def reproject(V_loc, w_loc):
            # CGS2 with the basis row-sharded: coefficients c = V·w need the
            # full-length dot, i.e. one psum of a (k,) vector; the update is
            # local. Unfilled (zero) rows of V contribute nothing.
            for _ in range(2):
                c = jax.lax.psum(V_loc @ w_loc, ROWS)
                w_loc = w_loc - V_loc.T @ c
            return w_loc

        var = lambda v: jax.lax.pcast(v, ROWS, to="varying")
        v0n = v0_full * live
        v0n = v0n / jnp.maximum(jnp.linalg.norm(v0n), 1e-30)
        v0n = var(v0n)
        V_loc = jnp.zeros((k, rps), jnp.float32).at[0].set(myslice(v0n))

        def step(carry, j):
            V_loc, vj_full = carry
            w_full = matvec(vj_full)
            alpha = jnp.vdot(vj_full, w_full)  # redundant on every device
            w_loc = reproject(V_loc, myslice(w_full))
            beta = jnp.sqrt(jax.lax.psum(jnp.vdot(w_loc, w_loc), ROWS))
            broke = beta <= eps * jnp.maximum(jnp.abs(alpha), 1.0)

            # Deterministic restart direction (same formula as the
            # single-device solver), masked to live rows, re-projected.
            fresh_full = jnp.sin(
                (jnp.arange(pr, dtype=jnp.float32) + 1.0) * (1.0 + j)
            ) * live
            fresh_loc = reproject(V_loc, myslice(var(fresh_full)))
            fnorm = jnp.sqrt(
                jax.lax.psum(jnp.vdot(fresh_loc, fresh_loc), ROWS))
            fresh_loc = fresh_loc / jnp.maximum(fnorm, 1e-30)

            v_next_loc = jnp.where(broke, fresh_loc,
                                   w_loc / jnp.maximum(beta, 1e-30))
            beta = jnp.where(broke, 0.0, beta)
            V_loc = jax.lax.cond(
                j + 1 < k,
                lambda V: V.at[j + 1].set(v_next_loc),
                lambda V: V,
                V_loc,
            )
            v_next_full = jax.lax.all_gather(v_next_loc, ROWS, tiled=True)
            return (V_loc, v_next_full), (alpha, beta)

        (_, _), (alphas, betas) = jax.lax.scan(
            step, (V_loc, v0n), jnp.arange(k, dtype=jnp.int32))
        # alphas/betas are identical on every device but flagged varying
        # (they flowed through collectives); emit one row per device and let
        # the P("rows") out_spec stack them — caller reads row 0.
        return jnp.stack([alphas, betas])[None]

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROWS), P(ROWS), P(ROWS), P()),
        out_specs=P(ROWS),
    )
    ab = f(sa.indptr, sa.indices, sa.values, v0)
    return ab[0, 0], ab[0, 1, :-1]


def lanczos_sharded(sa: ShardedCSR, mesh, k: int, *, n: int | None = None,
                    seed: int = 0) -> Tuple[jax.Array, jax.Array]:
    """k Lanczos steps on a row-sharded symmetric matrix. Returns the
    tridiagonal coefficients (alphas (k,), betas (k-1,))."""
    n = sa.rows if n is None else n
    k = int(min(k, n))
    v0 = jax.random.normal(jax.random.PRNGKey(seed), (sa.padded_rows,),
                           jnp.float32)
    return _lanczos_sharded_jit(sa, v0, k, mesh, n=n)


def eigen_values_lanczos_sharded(sa: ShardedCSR, mesh, k: int = 32, *,
                                 n: int | None = None,
                                 seed: int = 0) -> jax.Array:
    """k Ritz values (ascending) of a row-sharded symmetric matrix —
    extremal values converge first; exact spectrum at ``k == n``."""
    alphas, betas = lanczos_sharded(sa, mesh, k, n=n, seed=seed)
    t = jnp.diag(alphas)
    if alphas.shape[0] > 1:
        t = t + jnp.diag(betas, 1) + jnp.diag(betas, -1)
    return jnp.linalg.eigvalsh(t)
