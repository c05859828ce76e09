"""Cholesky factorization.

Reference counterpart: ``cholesky_decomp`` (``/root/reference/src/
sparse.rs:682-714``) — a scalar Cholesky–Banachiewicz triple loop that
materialises zero-filled rows of the partially-built factor at every inner
step. Despite operating on a sparse type, its compute is dense-logic; the
factor's sparsity is a storage property only. That frees this implementation
to produce the factor *values* any way that matches.

Paths:
* :func:`cholesky_dense` — jittable dense factorization (XLA's blocked
  Cholesky). The right tool at reference scale and for dense-ish
  SPD blocks.
* :func:`cholesky` — CSR→CSR wrapper with the reference's ``NonSquareMatrix``
  error; densifies, factors on device, re-sparsifies on host (exact zeros
  dropped, matching reference storage).
* Level-scheduled *sparse* numeric factorization for large structured SPD
  matrices lives in ``models/sparse_cholesky.py`` (symbolic analysis in the
  native runtime), dispatched by :func:`cholesky_auto`.

Like the reference (no SPD check — NaN propagates on non-SPD input,
sparse.rs:704), we do not validate positive-definiteness.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.csr import CSR
from ..utils.errors import NonSquareMatrix, check


@jax.jit
def cholesky_dense(a: jax.Array) -> jax.Array:
    """Lower-triangular Cholesky factor of a dense SPD matrix."""
    return jnp.linalg.cholesky(a.astype(jnp.float32))


def cholesky(a: CSR) -> CSR:
    """CSR → CSR lower Cholesky factor — reference ``cholesky_decomp``
    (sparse.rs:682-714) including its non-square error
    (sparse.rs:683-685)."""
    check(a.rows == a.cols, NonSquareMatrix,
          f"cholesky requires square matrix, got {a.dims}")
    l_dense = jax.device_get(cholesky_dense(a.todense()))
    return CSR.from_dense(l_dense)


# Parity alias matching the reference method name.
cholesky_decomp = cholesky


def cholesky_auto(a: CSR) -> CSR:
    """Dispatch: dense XLA path for small/dense matrices; for large sparse
    SPD, the supernodal panel factorization when the pattern amalgamates
    into panels (average width ≥ 2 — dense panel updates), else the scalar
    scatter-list path."""
    check(a.rows == a.cols, NonSquareMatrix,
          f"cholesky requires square matrix, got {a.dims}")
    from ..utils.config import get_config

    cfg = get_config()
    if (a.rows <= cfg.dense_cholesky_max_n
            or a.get_density() > cfg.dense_cholesky_min_density):
        return cholesky(a)
    from . import banded as _bd
    from . import sparse_cholesky as _sc
    from . import supernodal as _sn

    # banded block-tridiagonal scan when the given-order bandwidth is small
    # (cholesky matches the reference's factor-in-given-order semantics, so
    # no reordering here — solve_sparse reorders before its banded check)
    nb = _bd.banded_block_choice(a)
    if nb is not None:
        return _bd.assemble_factor_csr(_bd.factor_banded(a, nb))
    width, _ = _sn.supernode_stats(a, relax=cfg.supernodal_relax)
    if width >= 2.0:
        # panels amalgamate → dense panel updates pay off
        import jax
        import numpy as np

        sched = _sn.analyze_supernodal(a, relax=cfg.supernodal_relax)
        lvals = np.asarray(
            jax.device_get(_sn.factorize_supernodal(sched, a.values)))
        # sched is mandatory here: with relax > 0 the analyzed pattern is
        # EXPANDED vs chol_symbolic's, so lvals only aligns with sched's
        # own l_pattern (assemble without it silently truncates).
        return _sn.assemble_factor(a, lvals, sched)
    return _sc.cholesky_sparse(a)
