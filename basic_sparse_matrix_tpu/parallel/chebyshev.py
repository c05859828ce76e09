"""Distributed Chebyshev semi-iteration — zero reductions in the loop.

Distributed CG (``parallel/cg.py``) needs its vectors replicated so each
device can compute the global dot products its scalar recurrences depend
on. Chebyshev's scalars are data-independent (fixed recurrence from the
spectral bounds, see ``models/chebyshev.py``), so here everything stays
**row-sharded end to end**: x, r, d live as per-device blocks, the only
collective per iteration is the matvec's tiled ``all_gather`` of d — no
psum, no replication of state. Per-iteration comm = one length-n vector;
per-device memory O(n/ndev). The spectral bounds come from the
distributed Lanczos (``parallel/lanczos.py``), so the whole pipeline never
assembles the matrix or any full-length state beyond the gathered operand.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .lanczos import eigen_values_lanczos_sharded
from .mesh import ROWS
from .sharded import ShardedCSR
from .spmm import _local_spmv


@functools.partial(jax.jit, static_argnums=(4, 5))
def _cheby_sharded_jit(sa: ShardedCSR, b: jax.Array, lam_min: jax.Array,
                       lam_max: jax.Array, iters: int, mesh):
    rps = sa.rows_per_shard

    def body(indptr, indices, values, b_full, lo, hi):
        indptr, indices, values = indptr[0], indices[0], values[0]
        me = jax.lax.axis_index(ROWS)
        b_loc = jax.lax.dynamic_slice_in_dim(b_full, me * rps, rps)

        theta = (hi + lo) / 2.0
        delta = jnp.maximum((hi - lo) / 2.0, 1e-30)
        sigma1 = theta / delta

        def matvec_of_sharded(d_loc):
            d_full = jax.lax.all_gather(d_loc, ROWS, tiled=True)
            return _local_spmv(sa, indptr, indices,
                               values.astype(jnp.float32), d_full)

        # b_loc sliced at a device-varying offset is already "varying";
        # only rho (built from the replicated bounds) needs the pcast.
        x = jnp.zeros_like(b_loc)
        r = b_loc
        d = b_loc / theta
        rho = jax.lax.pcast(1.0 / sigma1, ROWS, to="varying")

        def step(_, carry):
            x, r, d, rho = carry
            x = x + d
            r = r - matvec_of_sharded(d)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            return x, r, d, rho_new

        x, r, d, rho = jax.lax.fori_loop(0, iters, step, (x, r, d, rho))
        # One psum AFTER the loop for the reported residual norm.
        rnorm = jnp.sqrt(jax.lax.psum(jnp.vdot(r, r), ROWS))
        bnorm = jnp.sqrt(jax.lax.psum(jnp.vdot(b_loc, b_loc), ROWS))
        return x, (rnorm / jnp.maximum(bnorm, 1e-30))[None]

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROWS), P(ROWS), P(ROWS), P(), P(), P()),
        out_specs=(P(ROWS), P(ROWS)),
    )
    x, res = f(sa.indptr, sa.indices, sa.values, b, lam_min, lam_max)
    return x, res[0]


def chebyshev_solve_sharded(sa: ShardedCSR, b: jax.Array, mesh, *,
                            iters: int = 100,
                            bounds: Optional[Tuple[float, float]] = None,
                            lanczos_k: int = 32,
                            n: int | None = None
                            ) -> Tuple[jax.Array, float]:
    """Solve SPD row-sharded ``A x = b`` by Chebyshev semi-iteration.
    ``b`` replicated (padded tail zero); returns (x row-sharded of length
    padded_rows, final relative residual). ``bounds`` estimated by the
    distributed Lanczos when omitted."""
    n = sa.rows if n is None else n
    if bounds is None:
        ritz = eigen_values_lanczos_sharded(sa, mesh, lanczos_k, n=n)
        lo, hi = float(ritz[0]), float(ritz[-1])
        if lo <= 0.0:
            raise ValueError(
                f"chebyshev needs SPD: smallest Ritz value {lo} <= 0")
        bounds = (0.95 * lo, 1.01 * hi)
    pr = sa.padded_rows
    b_padded = jnp.pad(jnp.asarray(b, jnp.float32), (0, pr - b.shape[0]))
    x, res = _cheby_sharded_jit(sa, b_padded, jnp.float32(bounds[0]),
                                jnp.float32(bounds[1]), iters, mesh)
    return x, float(res)
