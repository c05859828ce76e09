"""QR decomposition and QR-iteration eigenvalues.

Reference counterparts: ``qr_decomp`` (``/root/reference/src/
sparse.rs:716-756``) — explicit Householder deflation driving repeated
SpGEMMs, submatrix shrinks and re-embeddings (O(n⁴)-ish) — and
``eigen_values`` (sparse.rs:758-774), unshifted QR iteration with a
caller-chosen iteration count and no convergence test.

Device-native: XLA's blocked Householder QR on the densified operand (one
``jnp.linalg.qr`` call), and the eigenvalue iteration as a ``lax.fori_loop``
so the whole loop compiles once. The reference's only QR assertion is
residual-based (``‖A − QR‖₂ < 0.1``, sparse.rs:1380), so sign-convention
differences are immaterial. These are correctness-tier ops (kept for surface
parity), not performance-tier.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.csr import CSR
from ..utils.errors import IncorrectDimensions, NonSquareMatrix, check


def _check_densify_budget(a: CSR, op: str) -> None:
    """These are dense-delegation ops; refuse inputs whose densified form
    exceeds the dispatch budget (mirrors spmm_auto's
    ``dense_dispatch_max_bytes``) instead of OOMing inside todense()."""
    from ..utils.config import get_config

    limit = get_config().dense_dispatch_max_bytes
    check(4 * a.rows * a.cols <= limit, IncorrectDimensions,
          f"{op}: densified operand {a.dims} needs {4 * a.rows * a.cols} "
          f"bytes > dense_dispatch_max_bytes={limit}; this op has no sparse "
          f"path (raise BSM_DENSE_DISPATCH_MAX_BYTES to override, or for "
          f"symmetric eigenvalues use models.lanczos.eigen_values_lanczos)")


@jax.jit
def qr_dense(a: jax.Array) -> Tuple[jax.Array, jax.Array]:
    return jnp.linalg.qr(a.astype(jnp.float32), mode="reduced")


DEFAULT_TSQR_BLOCK = 1024


@functools.partial(jax.jit, static_argnums=(1,))
def tsqr_dense(a: jax.Array, block_rows: int = DEFAULT_TSQR_BLOCK
               ) -> Tuple[jax.Array, jax.Array]:
    """Communication-avoiding tall-skinny QR (TSQR): batched Householder
    QR over row blocks, then a log2-depth tree of (2n, n) stacked-R
    factorizations, then the Q factors multiplied back down the tree — the
    whole pipeline is batched matmul work in one compiled program, against
    the single long Householder chain of ``jnp.linalg.qr`` (sequential in
    the row dimension). The reference's Householder deflation
    (sparse.rs:716-756) is O(n^4)-ish scalar code; this is the batched
    algorithm for the tall operands where QR actually scales.

    Requires ``m >= n``; returns reduced (Q (m, n), R (n, n)). R's rows
    carry QR's usual sign ambiguity (the reference's own test asserts only
    the residual, sparse.rs:1380)."""
    m, n = a.shape
    prec = jax.lax.Precision.HIGHEST
    a = a.astype(jnp.float32)
    br = max(block_rows, n)
    B = -(-m // br)
    Bp = 1 << max(B - 1, 0).bit_length()          # pad blocks to a pow2
    a = jnp.pad(a, ((0, Bp * br - m), (0, 0)))
    q0, r = jnp.linalg.qr(a.reshape(Bp, br, n))   # (B, br, n), (B, n, n)
    tree = []
    nb = Bp
    while nb > 1:
        q2, r = jnp.linalg.qr(r.reshape(nb // 2, 2 * n, n))
        tree.append(q2)                           # (nb/2, 2n, n)
        nb //= 2
    R = r[0]
    acc = jnp.eye(n, dtype=jnp.float32)[None]     # (1, n, n)
    for q2 in reversed(tree):
        piece = jnp.matmul(q2, acc, precision=prec)   # (P, 2n, n)
        acc = piece.reshape(-1, n, n)
    Q = jnp.matmul(q0, acc, precision=prec).reshape(Bp * br, n)[:m]
    return Q, R


def tsqr(a, block_rows: int = DEFAULT_TSQR_BLOCK
         ) -> Tuple[jax.Array, jax.Array]:
    """TSQR of a tall operand (CSR or dense array) — see
    :func:`tsqr_dense`. Sparse operands densify (Q is inherently dense)."""
    arr = a.todense() if isinstance(a, CSR) else jnp.asarray(a)
    check(arr.shape[0] >= arr.shape[1], IncorrectDimensions,
          f"tsqr needs rows >= cols, got {arr.shape}")
    return tsqr_dense(arr, block_rows)


# TSQR routing threshold: XLA's blocked Householder QR is taken unless the
# operand is extremely tall-skinny. The crossover on the GPU is not
# measured yet (PERF.md, open questions).
TSQR_MIN_ASPECT = 4096


def qr_decomp(a: CSR) -> Tuple[CSR, CSR]:
    """QR of a CSR matrix — reference ``qr_decomp`` (sparse.rs:716-756).
    Returns (Q, R) as CSR (host re-sparsified, exact zeros dropped).
    Extreme tall-skinny operands (rows >= TSQR_MIN_ASPECT*cols — see the
    threshold above) route through the blocked TSQR tree;
    everything else uses XLA's Householder QR directly. (TSQR's main
    role is the DISTRIBUTED factorization — parallel/tsqr.py — where
    the single long Householder chain cannot shard.)"""
    _check_densify_budget(a, "qr_decomp")
    if a.rows >= TSQR_MIN_ASPECT * a.cols:
        q, r = jax.device_get(tsqr_dense(a.todense()))
    else:
        q, r = jax.device_get(qr_dense(a.todense()))
    return CSR.from_dense(q), CSR.from_dense(r)


@functools.partial(jax.jit, static_argnums=(1,))
def eigen_values_dense(a: jax.Array, iterations: int) -> jax.Array:
    """Unshifted QR iteration: ``A ← R Q`` repeated ``iterations`` times,
    then the diagonal — reference ``eigen_values`` (sparse.rs:758-774)."""

    def body(_, working):
        q, r = jnp.linalg.qr(working)
        return jnp.matmul(r, q, precision=jax.lax.Precision.HIGHEST)

    out = jax.lax.fori_loop(0, iterations, body,
                            a.astype(jnp.float32))
    return jnp.diagonal(out)


def eigen_values(a: CSR, iterations: int) -> jax.Array:
    check(a.rows == a.cols, NonSquareMatrix,
          f"eigen_values requires square matrix, got {a.dims}")
    _check_densify_budget(a, "eigen_values")
    return eigen_values_dense(a.todense(), iterations)


@jax.jit
def eigen_values_sym_dense(a: jax.Array) -> jax.Array:
    """Symmetric fast path: ``eigh`` instead of QR iteration — exact
    spectrum in one call (ascending order)."""
    return jnp.linalg.eigvalsh(a.astype(jnp.float32))


def eigen_values_sym(a: CSR) -> jax.Array:
    """Eigenvalues of a symmetric CSR matrix via ``eigh`` (the converged
    answer the reference's unshifted QR iteration approaches)."""
    check(a.rows == a.cols, NonSquareMatrix,
          f"eigen_values_sym requires square matrix, got {a.dims}")
    _check_densify_budget(a, "eigen_values_sym")
    return eigen_values_sym_dense(a.todense())
