"""Level-set-parallel sparse triangular solve.

Reference counterpart: ``forward_substitution`` / ``backward_substitution``
(the reference crate's ``src/lib.rs:28-65``) — strictly sequential row
loops. This rebuild breaks the sequential chain with **level scheduling**
(SURVEY.md §7 step 4): the native runtime (`runtime/symbolic.level_sets`)
computes each row's dependency depth; rows within a level are independent
and solve as one batched gather/scatter step. The schedule (static, host-precomputed, padded
to per-level maxima) is closed over by a jit-compiled ``lax.fori_loop`` over
levels.

Cost model: work is O(nnz) like the scalar loop, but wall-clock is
O(n_levels) serial steps instead of O(n) — for a 2D-Laplacian-style factor,
levels ≈ O(√n).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.csr import CSR
from ..runtime import symbolic
from ..utils.errors import IncorrectDimensions, NonSquareMatrix, check


@dataclasses.dataclass(frozen=True)
class TriangularSchedule:
    """Static padded solve schedule for one triangular CSR matrix.

    ``rows_by_level[l, r]`` — row index (or n, padded) of the r-th row in
    level ``l``. ``dep_cols/dep_vals`` give each scheduled row's off-diagonal
    entries padded to the global max row length; ``inv_diag`` its reciprocal
    diagonal.
    """

    rows_by_level: jax.Array  # (nlev, max_rows) int32, pad = n
    dep_cols: jax.Array       # (nlev, max_rows, max_deps) int32, pad = n
    dep_vals: jax.Array       # (nlev, max_rows, max_deps)
    inv_diag: jax.Array       # (nlev, max_rows)
    n: int
    lower: bool


def build_schedule(l: CSR, *, lower: bool = True) -> TriangularSchedule:
    """Host-side analysis: level sets + padded gather tables."""
    check(l.rows == l.cols, NonSquareMatrix, "triangular solve needs square")
    n = l.rows
    indptr, indices, values = l.numpy()
    if not lower:
        # Upper-triangular: mirror to a lower problem on reversed indices.
        perm = np.arange(n)[::-1]
        dense_like_rows = []
        # re-index: row i -> n-1-i, col j -> n-1-j; CSR of mirrored matrix
        rows = np.repeat(np.arange(n), np.diff(indptr))
        m_rows, m_cols = n - 1 - rows, n - 1 - indices
        order = np.lexsort((m_cols, m_rows))
        m_rows, m_cols, m_vals = m_rows[order], m_cols[order], values[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr[1:], m_rows, 1)
        indptr = np.cumsum(indptr)
        indices, values = m_cols, m_vals

    level, nlev = symbolic.level_sets(n, indptr, indices)
    rows_of_level = [np.nonzero(level == lv)[0] for lv in range(nlev)]
    max_rows = max(len(r) for r in rows_of_level)
    row_len = np.diff(indptr)
    max_deps = max(int(row_len.max()) - 1, 1) if n else 1

    rbl = np.full((nlev, max_rows), n, dtype=np.int32)
    dcols = np.full((nlev, max_rows, max_deps), n, dtype=np.int32)
    dvals = np.zeros((nlev, max_rows, max_deps), dtype=np.float32)
    idiag = np.zeros((nlev, max_rows), dtype=np.float32)
    for lv, rows_ in enumerate(rows_of_level):
        rbl[lv, : len(rows_)] = rows_
        for r, i in enumerate(rows_):
            lo, hi = int(indptr[i]), int(indptr[i + 1])
            cols_i = indices[lo:hi]
            vals_i = values[lo:hi]
            off = cols_i != i
            k = int(off.sum())
            dcols[lv, r, :k] = cols_i[off]
            dvals[lv, r, :k] = vals_i[off]
            diag = vals_i[~off]
            check(diag.size == 1 and diag[0] != 0, IncorrectDimensions,
                  f"missing/zero diagonal at row {i}")
            idiag[lv, r] = 1.0 / float(diag[0])
    return TriangularSchedule(
        rows_by_level=jnp.asarray(rbl),
        dep_cols=jnp.asarray(dcols),
        dep_vals=jnp.asarray(dvals),
        inv_diag=jnp.asarray(idiag),
        n=n,
        lower=lower,
    )


@partial(jax.jit, static_argnums=())
def _solve_scheduled(sched: TriangularSchedule, b: jax.Array) -> jax.Array:
    # x carries one scratch row at index n: padded gathers read/write it
    # harmlessly.
    nlev = sched.rows_by_level.shape[0]
    x = jnp.concatenate(
        [b.astype(jnp.float32),
         jnp.zeros((1,) + b.shape[1:], dtype=jnp.float32)]
    )

    def level_step(lv, x):
        rows = sched.rows_by_level[lv]          # (R,)
        cols = sched.dep_cols[lv]               # (R, D)
        vals = sched.dep_vals[lv]               # (R, D)
        idg = sched.inv_diag[lv]                # (R,)
        acc = jnp.einsum("rd,rd...->r...", vals, x[cols],
                         precision=jax.lax.Precision.HIGHEST)
        new = (x[rows] - acc) * (
            idg.reshape((-1,) + (1,) * (x.ndim - 1))
        )
        return x.at[rows].set(new, mode="drop")

    x = jax.lax.fori_loop(0, nlev, level_step, x)
    return x[: sched.n]


jax.tree_util.register_dataclass(
    TriangularSchedule,
    data_fields=["rows_by_level", "dep_cols", "dep_vals", "inv_diag"],
    meta_fields=["n", "lower"],
)


def solve_triangular_sparse(l: CSR, b,
                            sched: Optional[TriangularSchedule] = None,
                            *, lower: bool = True) -> jax.Array:
    """Sparse triangular solve ``L x = b`` via level scheduling. Pass a
    prebuilt ``sched`` to amortise analysis across solves (the common case in
    ``solve``)."""
    if sched is None:
        sched = build_schedule(l, lower=lower)
    b = jnp.asarray(b)
    if not sched.lower:
        # Mirrored problem: reverse rows of b and of the solution.
        rev = jnp.flip(b, axis=0)
        return jnp.flip(_solve_scheduled(sched, rev), axis=0)
    return _solve_scheduled(sched, b)
