"""SpMM (CSR × dense) and SpMV — the framework's flagship compute path.

Reference counterparts: ``mul_dense`` / ``mul_dense_s`` (``/root/reference/
src/sparse.rs:426-466``) and ``mul_vector`` (sparse.rs:468-482). The reference
runs a scalar triple loop and — an API quirk — stores the *dense* product back
into a CSR, dropping exact zeros (pinned by its ``test_nnz``,
sparse.rs:1154-1178). SpMM here produces a dense output array; use
:func:`spmm_to_csr` for the reference-shaped result.

Execution paths (``spmm_auto`` dispatches by density/structure):
* dense matmul over the memoised densified operand (at or above
  ``config.dense_dispatch_density``)
* ``spmm_ell`` (ops/ell.py) — padded-row gather+reduce, no scatter (low
  row-length variance)
* ``spmm`` — gather/segment-sum baseline: pure XLA, any shape; the test
  oracle for the others and the traced/CPU fallback.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.errors import IncorrectDimensions, check
from .csr import CSR


@jax.jit
def spmm(a: CSR, b: jax.Array) -> jax.Array:
    """Gather-based SpMM: ``out[i, :] = Σ_k A[i,k]·B[k, :]``.

    Gathers the needed rows of ``B`` by column index, scales by the stored
    values, and segment-sums into output rows (sorted segment ids from
    ``indptr``). Static nnz keeps the whole computation traceable.
    """
    gathered = b[a.indices] * a.values[:, None].astype(b.dtype)
    return jax.ops.segment_sum(
        gathered, a.row_ids(), num_segments=a.rows, indices_are_sorted=True
    )


@jax.jit
def spmv(a: CSR, x: jax.Array) -> jax.Array:
    """Sparse matrix × vector — reference ``mul_vector``
    (sparse.rs:468-482), which transposes the whole matrix first; here it is
    just the N=1 degenerate gather/segment-sum."""
    prod = a.values.astype(x.dtype) * x[a.indices]
    return jax.ops.segment_sum(
        prod, a.row_ids(), num_segments=a.rows, indices_are_sorted=True
    )


def mul_dense(a: CSR, b) -> jax.Array:
    """Checked SpMM entry point — reference ``mul_dense`` (sparse.rs:426-446)
    including its ``IncorrectDimensions`` error."""
    b = jnp.asarray(b)
    check(b.ndim == 2 and a.cols == b.shape[0], IncorrectDimensions,
          f"mul_dense: {a.dims} × {b.shape}")
    return spmm_auto(a, b)


def mul_vector(a: CSR, x) -> jax.Array:
    """Checked SpMV — reference ``mul_vector`` (sparse.rs:468-482)."""
    x = jnp.asarray(x)
    check(x.ndim == 1 and a.cols == x.shape[0], IncorrectDimensions,
          f"mul_vector: {a.dims} × {x.shape}")
    return spmv(a, x)


def spmm_to_csr(a: CSR, b) -> CSR:
    """Reference-shaped result: dense product re-sparsified (exact zeros
    dropped), matching ``mul_dense``'s CSR output and its nnz semantics
    (sparse.rs:442, test sparse.rs:1154-1178). Host-side."""
    return CSR.from_dense(jax.device_get(mul_dense(a, b)))


def spmm_auto(a: CSR, b: jax.Array) -> jax.Array:
    """Density-dispatched SpMM, the ladder a cuSPARSE/cuBLAS user would
    pick by hand:

    * **dense** (density ≥ ``config.dense_dispatch_density`` and the
      densified A fits ``dense_dispatch_max_bytes``): one matmul against
      the memoised densified operand; the densify happens once per matrix.
    * **ELL** (padding overhead ≤ ``config.ell_max_overhead``): padded-row
      gather+FMA, no scatter.
    * **gather/segment** (skewed rows or traced operands): the general
      fallback.
    """
    from ..utils.config import get_config, matmul_precision

    cfg = get_config()
    concrete = not isinstance(a.values, jax.core.Tracer)
    if (
        concrete
        and a.get_density() >= cfg.dense_dispatch_density
        and 4 * a.rows * a.cols <= cfg.dense_dispatch_max_bytes
    ):
        dense = getattr(a, "_dense_cache", None)
        if dense is None:
            dense = a.todense().astype(jnp.float32)
            object.__setattr__(a, "_dense_cache", dense)
        return jnp.dot(dense, b.astype(dense.dtype),
                       precision=matmul_precision())
    if concrete and a.stored:
        from . import ell as _e

        if _e.ell_overhead(a) <= cfg.ell_max_overhead:
            return _e.spmm_ell_from_csr(a, b)
    return spmm(a, b)
