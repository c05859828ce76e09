"""Linear-system solver: Cholesky → forward → backward substitution.

Reference counterpart: ``solve`` (``/root/reference/src/lib.rs:11-24``):
``A = L·Lᵀ``; ``L y = b``; ``Lᵀ x = y``. The reference transposes L
explicitly and loops columns of b; here the pipeline is one jit-compiled
device program (transpose folded into ``solve_triangular``'s trans flag, RHS
batched).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..ops.csr import CSR
from ..ops.dense import Dense
from ..utils.errors import IncorrectDimensions, NonSquareMatrix, check
from .triangular import _as_array


@jax.jit
def solve_dense(a: jax.Array, b: jax.Array) -> jax.Array:
    """Jittable SPD solve on dense operands: one fused factor+solve
    pipeline."""
    from ..utils.config import factor_precision

    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    with factor_precision():
        l = jnp.linalg.cholesky(a)
        y = jsl.solve_triangular(l, b, lower=True)
        return jsl.solve_triangular(l, y, lower=True, trans=1)


def solve(a: CSR, b) -> jax.Array:
    """Solve ``A x = b`` for SPD sparse ``A`` — reference ``solve``
    (lib.rs:11-24). ``b`` may be a Dense wrapper, 1D vector, or (n, k)
    array; returns an (n, k) array."""
    check(a.rows == a.cols, NonSquareMatrix,
          f"solve requires square A, got {a.dims}")
    rhs = _as_array(b)
    check(rhs.shape[0] == a.rows, IncorrectDimensions,
          f"solve: A {a.dims} vs b {rhs.shape}")
    return solve_dense(a.todense(), rhs)


class DirectSolver:
    """Prepared sparse direct solver: fill-reducing ordering, numeric
    factorization, and triangular-solve schedules built ONCE at
    construction; :meth:`solve` then runs only device programs. The
    serving-path analogue of scipy's ``factorized`` — cached by
    ``SparseOperator`` and used one-shot by :func:`solve_sparse`.

    Factorization backend, cheapest check first:

    1. banded block-tridiagonal scan when the (reordered) bandwidth fits a
       small block — one shape for the whole factorization + both solves;
    2. supernodal panel phase when the pattern amalgamates into panels;
       the factor stays on the device as flat CSC values and the solves
       run panel by panel (:mod:`models.supernodal_solve`);
    3. scalar scatter-list path otherwise, with level-set solves. The
       supernodal dispatch uses the cheap partition-only pass; the full
       schedule is built only when it wins, and both share one
       chol_symbolic via the instance cache.
    """

    def __init__(self, a: CSR, *, reorder: bool = True):
        from ..ops.reorder import (
            best_permutation,
            nd_permutation,
            permute_symmetric,
            rcm_permutation,
        )
        from ..utils.config import get_config
        from . import banded as _bd

        check(a.rows == a.cols, NonSquareMatrix,
              f"sparse direct solve requires square A, got {a.dims}")
        self.n = a.rows
        self.perm = None
        if reorder:
            ordering = get_config().ordering
            if ordering == "auto":
                self.perm, _ = best_permutation(a)
            elif ordering == "rcm":
                self.perm = rcm_permutation(a)
            elif ordering == "nd":
                self.perm = nd_permutation(a)
            if self.perm is not None:
                a = permute_symmetric(a, self.perm)
        self._banded = None
        self._l = self._fwd = self._bwd = None
        nb = _bd.banded_block_choice(a)
        if nb is not None:
            if get_config().banded_solver == "bcr":
                from . import bcr as _bcr

                self.kind = "banded-bcr"
                self._banded = _bcr.prepare_bcr(a, nb)
            else:
                self.kind = "banded"
                self._banded = _bd.factor_banded(a, nb)
            return
        from . import supernodal as _sn
        from .sparse_cholesky import cholesky_sparse
        from .sparse_triangular import build_schedule

        width, _ = _sn.supernode_stats(a, relax=get_config().supernodal_relax)
        if width >= 2.0:
            from .supernodal_solve import build_panel_solve

            sched = _sn.analyze_supernodal(
                a, relax=get_config().supernodal_relax)
            self._lvals = _sn.factorize_supernodal(sched, a.values)
            self._panels = build_panel_solve(sched)
            self.kind = "supernodal"
            return
        self._l = cholesky_sparse(a)
        self.kind = "scatter"
        self._fwd = build_schedule(self._l, lower=True)
        self._bwd = build_schedule(self._l.transpose(), lower=False)

    def solve(self, b) -> jax.Array:
        """Solve ``A x = b`` from the prepared factorization; ``b`` may be a
        Dense wrapper, 1D vector, or (n, k) array. 1D input returns 1D."""
        from ..ops.reorder import apply_perm
        from . import banded as _bd
        from .sparse_triangular import solve_triangular_sparse

        rhs = _as_array(b)
        squeeze = not isinstance(b, Dense) and jnp.asarray(b).ndim == 1
        check(rhs.shape[0] == self.n, IncorrectDimensions,
              f"solve: A n={self.n} vs b {rhs.shape}")
        if self.perm is not None:
            rhs = apply_perm(rhs, self.perm)
        if self._banded is not None:
            if self.kind == "banded-bcr":
                x = self._banded.solve(rhs)
            else:
                x = _bd.solve_factored_banded(self._banded, rhs)
        elif self.kind == "supernodal":
            from .supernodal_solve import solve_panels

            y = solve_panels(self._panels, self._lvals, rhs)
            x = solve_panels(self._panels, self._lvals, y, transpose=True)
        else:
            y = solve_triangular_sparse(self._l, rhs, self._fwd)
            x = solve_triangular_sparse(self._l, y, self._bwd, lower=False)
        if self.perm is not None:
            x = apply_perm(x, self.perm, inverse=True)
        return x[:, 0] if squeeze else x


def prepare_direct(a: CSR, *, reorder: bool = True) -> DirectSolver:
    """Build a reusable :class:`DirectSolver` (ordering + factorization +
    solve schedules, all one-time) for repeated right-hand sides."""
    return DirectSolver(a, reorder=reorder)


def solve_sparse(a: CSR, b, *, reorder: bool = True) -> jax.Array:
    """Fully sparse solve pipeline: fill-reducing preordering (config
    ``ordering``: auto picks the lower predicted fill of RCM vs nested
    dissection — internal, the returned x is for the original system) →
    banded / supernodal / level-scheduled Cholesky factorization (symbolic
    analysis in the native runtime) → batched-scan or level-set-parallel
    forward/backward substitution. The scalable counterpart of :func:`solve`
    for matrices where densifying is wasteful."""
    return DirectSolver(a, reorder=reorder).solve(_as_array(b))


def solve_auto(a: CSR, b) -> jax.Array:
    """Dispatch between the dense XLA pipeline (small or dense-ish A) and
    the sparse level-scheduled pipeline (large sparse A) — mirroring
    ``cholesky_auto``'s policy."""
    from ..utils.config import get_config

    cfg = get_config()
    if (a.rows <= cfg.dense_cholesky_max_n
            or a.get_density() > cfg.dense_cholesky_min_density):
        return solve(a, b)
    return solve_sparse(a, b)
