"""DistributedOperator — the mesh-resident serving wrapper.

Mirrors :class:`~basic_sparse_matrix_tpu.models.operator.SparseOperator`
(the single-chip prepared wrapper) for row-sharded matrices: shard once,
then every product/solve/spectral call reuses the device-resident shards
and any lazily-built per-device preparation (block-Jacobi factors,
spectral bounds). No reference counterpart (the reference is single-core,
``/root/reference/src/lib.rs``); this is the user-facing face of SURVEY.md
§2's D1–D4 components.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.csr import CSR
from .mesh import ROWS, row_mesh
from .sharded import ShardedCSR, put_sharded, shard_csr, unshard_rows


class DistributedOperator:
    """Shard an SPD (for the solve paths) or general (for products) CSR over
    a row mesh once; serve repeated products, solves, and spectral queries
    from the resident shards."""

    def __init__(self, a: CSR, mesh=None):
        if mesh is None:
            mesh = row_mesh(len(jax.devices()))
        self.mesh = mesh
        self.a = a
        self.rows, self.cols = a.rows, a.cols
        self.sa: ShardedCSR = put_sharded(
            shard_csr(a, mesh.shape[ROWS]), mesh)
        self._ell = None           # row-sharded ELL view (lazy)
        self._lfac = None          # block-Jacobi factors (lazy)
        self._bounds = None        # Chebyshev spectral bounds (lazy)
        self._spgemm_plans = []    # (weakref(rhs), plans) — last 4 kept

    # -- products ---------------------------------------------------------
    def matvec(self, x) -> jax.Array:
        from .spmm import spmv_sharded

        y = spmv_sharded(self.sa, jnp.asarray(x, jnp.float32), self.mesh)
        return unshard_rows(y, self.rows)

    def matmul(self, b) -> jax.Array:
        """Row-sharded SpMM, replicated ``b``: over ELL shards (gather+FMA)
        when the padding stays under ``config.ell_max_overhead``, else the
        gather/segment-sum shards."""
        from ..ops.ell import ell_overhead
        from ..utils.config import get_config
        from .spmm import shard_ell, spmm_sharded, spmm_sharded_ell

        b = jnp.asarray(b, jnp.float32)
        if self._ell is None and self.a.stored and (
                ell_overhead(self.a) <= get_config().ell_max_overhead):
            self._ell = shard_ell(self.a, self.mesh)
        if self._ell is not None:
            y = spmm_sharded_ell(self._ell, b, self.mesh)
        else:
            y = spmm_sharded(self.sa, b, self.mesh)
        return unshard_rows(y, self.rows)

    def matmul_sparse(self, other: CSR) -> CSR:
        """Distributed SpGEMM against resident row blocks; the per-block
        symbolic plans are memoised per RHS pattern."""
        import weakref

        from .spgemm_sparse import plan_spgemm_sharded, spgemm_sharded

        plans = None
        for ref, p in self._spgemm_plans:
            if ref() is other:
                plans = p
                break
        if plans is None:
            plans = plan_spgemm_sharded(self.a, other,
                                        self.mesh.shape[ROWS])
            self._spgemm_plans.append((weakref.ref(other), plans))
            del self._spgemm_plans[:-4]
        return spgemm_sharded(self.a, other, self.mesh, plans=plans)

    # -- solves -----------------------------------------------------------
    def _ensure_block_jacobi(self):
        if self._lfac is None:
            from .pcg import build_block_jacobi

            self._lfac = build_block_jacobi(self.sa, self.mesh)
        return self._lfac

    def solve_cg(self, b, iters: int = 100) -> jax.Array:
        from .cg import cg_solve_sharded

        x = cg_solve_sharded(self.sa, jnp.asarray(b, jnp.float32),
                             self.mesh, iters=iters)
        return unshard_rows(x, self.rows)

    def solve_pcg(self, b, iters: int = 100) -> jax.Array:
        from .pcg import pcg_solve_sharded

        x = pcg_solve_sharded(self.sa, jnp.asarray(b, jnp.float32),
                              self.mesh, iters=iters,
                              lfac=self._ensure_block_jacobi())
        return unshard_rows(x, self.rows)

    def solve_chebyshev(self, b, iters: int = 100) -> jax.Array:
        from .chebyshev import chebyshev_solve_sharded

        if self._bounds is None:
            ritz = self.eigen_values(k=32)
            self._bounds = (0.95 * float(ritz[0]), 1.01 * float(ritz[-1]))
        x, _ = chebyshev_solve_sharded(
            self.sa, jnp.asarray(b, jnp.float32), self.mesh, iters=iters,
            bounds=self._bounds, n=self.rows)
        return unshard_rows(x, self.rows)

    # -- spectral ---------------------------------------------------------
    def eigen_values(self, k: int = 32) -> jax.Array:
        from .lanczos import eigen_values_lanczos_sharded

        return eigen_values_lanczos_sharded(self.sa, self.mesh, k,
                                            n=self.rows)
