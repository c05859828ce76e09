"""Symmetric permutations / reordering.

No reference counterpart — the reference factors matrices in given order.
Reordering is standard large-scale practice: RCM reduces bandwidth (gather
locality for SpMM; Cholesky fill) before factorization. ``permute_symmetric``
applies P·A·Pᵀ; solvers then work in permuted space with
``x = Pᵀ·x_permuted``.
"""

from __future__ import annotations

import numpy as np

from ..runtime import symbolic
from ..utils.errors import NonSquareMatrix, check
from .csr import CSR


def _sym_pattern(a: CSR):
    """Symmetrised adjacency (CSR indptr/indices) of A's pattern."""
    indptr, indices, _ = a.numpy()
    rows = np.repeat(np.arange(a.rows), np.diff(indptr))
    pr = np.concatenate([rows, indices])
    pc = np.concatenate([indices, rows])
    keys = np.unique(pr * a.rows + pc)
    sr, sc = keys // a.rows, keys % a.rows
    sp = np.zeros(a.rows + 1, dtype=np.int64)
    np.add.at(sp[1:], sr, 1)
    sp = np.cumsum(sp)
    return sp, sc


def rcm_permutation(a: CSR) -> np.ndarray:
    """RCM permutation from A's symmetrised pattern."""
    check(a.rows == a.cols, NonSquareMatrix, "rcm needs square")
    sp, sc = _sym_pattern(a)
    return symbolic.rcm_ordering(a.rows, sp, sc)


def nd_permutation(a: CSR, *, leaf: int = 64) -> np.ndarray:
    """Nested-dissection permutation (recursive BFS bisection, separators
    eliminated last). The right ordering for grid-like patterns at scale,
    where RCM's profile ordering stops reducing fill."""
    check(a.rows == a.cols, NonSquareMatrix, "nd needs square")
    sp, sc = _sym_pattern(a)
    return symbolic.nd_ordering(a.rows, sp, sc, leaf=leaf)


def chol_fill(a: CSR, perm: np.ndarray = None) -> int:
    """Predicted Cholesky factor nnz of A under ``perm`` (symbolic-only,
    native) — the objective orderings compete on."""
    sp, sc = _sym_pattern(a)
    n = a.rows
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        rows = np.repeat(inv, np.diff(sp))
        cols = inv[sc]
    else:
        rows = np.repeat(np.arange(n), np.diff(sp))
        cols = sc
    low = cols < rows
    lp = np.zeros(n + 1, dtype=np.int64)
    np.add.at(lp[1:], rows[low], 1)
    lp = np.cumsum(lp)
    order = np.argsort(rows[low] * n + cols[low], kind="stable")
    _, l_indptr, _ = symbolic.chol_symbolic(n, lp, cols[low][order])
    return int(l_indptr[-1])


# RCM's regular band shapes compile to few scanned groups and feed the
# banded tier, so RCM is preferred even at somewhat higher predicted fill
# — predicted nnz is a memory proxy, not a time proxy. ND is chosen only
# when its fill advantage is large (asymptotically guaranteed:
# O(n log n) vs O(n^1.5) on 2D meshes). The factor was set on a TPU; on
# the GPU it is not measured yet (PERF.md, open questions).
ND_FILL_FACTOR = 0.45


def best_permutation(a: CSR):
    """Ordering auto-choice by predicted factor fill (cheap native symbolic
    passes), device-time-biased: RCM wins ties and moderate fill gaps (its
    regular level shapes — see the ND_FILL_FACTOR note); ND
    wins when its fill is < ``ND_FILL_FACTOR``× RCM's; natural order wins
    only if it beats both outright. Returns ``(perm, name)`` with
    ``(None, 'natural')`` for the given order."""
    fills = {"natural": chol_fill(a)}
    perms = {}
    for name, fn in (("rcm", rcm_permutation), ("nd", nd_permutation)):
        try:
            perms[name] = fn(a)
            fills[name] = chol_fill(a, perms[name])
        except Exception:
            pass
    if "nd" in fills and fills["nd"] < ND_FILL_FACTOR * fills.get(
            "rcm", fills["natural"]):
        winner = "nd"
    elif "rcm" in fills and fills["rcm"] <= fills["natural"]:
        winner = "rcm"
    else:
        winner = min(fills, key=fills.get)
    return perms.get(winner), winner


def permute_symmetric(a: CSR, perm: np.ndarray) -> CSR:
    """P·A·Pᵀ: row/col i of the result is row/col ``perm[i]`` of ``a``."""
    check(a.rows == a.cols, NonSquareMatrix, "permute_symmetric needs square")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    indptr, indices, values = a.numpy()
    rows = np.repeat(np.arange(a.rows), np.diff(indptr))
    return CSR.from_coo_arrays(
        a.dims, inv[rows], inv[indices], values,
        sum_duplicates=False, drop_zeros=False,
    )


def apply_perm(x, perm: np.ndarray, inverse: bool = False):
    """Permute vector/matrix rows into (or out of) permuted space."""
    import jax.numpy as jnp

    perm = np.asarray(perm)
    if inverse:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0])
        perm = inv
    return jnp.asarray(x)[jnp.asarray(perm)]


def bandwidth(a: CSR) -> int:
    """Maximum |row − col| over stored entries."""
    indptr, indices, _ = a.numpy()
    if a.stored == 0:
        return 0
    rows = np.repeat(np.arange(a.rows), np.diff(indptr))
    return int(np.abs(rows - indices).max())
