"""Block cyclic reduction (BCR) — O(log m)-depth banded SPD solver.

Reference counterpart: ``solve`` (``/root/reference/src/lib.rs:11-24``) at
value level only; the algorithm has no reference analogue — it exists
because of the device cost model. The banded scan (``models/banded.py``) is
O(m) *sequential* block steps; each step is a small potrf/trsm/syrk with a
fixed launch latency, so wall-clock at large m is step-count-bound, not
flop-bound. Cyclic reduction restructures the
elimination: each level eliminates every odd-indexed block *in parallel*
(one batched Cholesky + batched triangular solves + batched matmuls over
m/2 blocks), producing a block-tridiagonal system of half the size — the
whole solve is 2·log2(m) *batched* steps at ~4× the flops, the trade an
accelerator wants.

Level algebra (row i: ``E_{i-1} x_{i-1} + D_i x_i + E_iᵀ x_{i+1} = b_i``,
``E_i`` couples block i+1 to block i):

    x_o = D_o⁻¹ (b_o − E_{o−1} x_{o−1} − E_oᵀ x_{o+1})        (odd o)

substituted into the even rows gives the half-size system

    D'_k = D_{2k} − E_{2k−1} Wr_{k−1} − E_{2k}ᵀ Wl_k
    E'_k = −E_{2k+1} Wl_k
    b'_k = b_{2k} − E_{2k−1} z_{k−1} − E_{2k}ᵀ z_k

with ``Wl_k = D_{2k+1}⁻¹ E_{2k}``, ``Wr_k = D_{2k+1}⁻¹ E_{2k+1}ᵀ``,
``z_k = D_{2k+1}⁻¹ b_{2k+1}`` (all batched Cholesky solves). The Schur
complements keep every level SPD. Everything b-independent (the Cholesky
factors of the odd diagonals, Wl, Wr, and the level coupling blocks) is
the *factorization* — computed once and reused per right-hand side.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..ops.csr import CSR
from ..utils.config import factor_precision, matmul_precision
from .banded import _blocked_rhs, band_blocks, bandwidth, block_size_for


def _mm(a, b):
    return jnp.matmul(a, b, precision=matmul_precision())


def _chol_solve(l: jax.Array, rhs: jax.Array) -> jax.Array:
    """Batched SPD solve from batched Cholesky factors: (B,nb,nb)×(B,nb,k)."""
    import jax.scipy.linalg as jsl

    y = jsl.solve_triangular(l, rhs, lower=True)
    return jsl.solve_triangular(l, y, lower=True, trans=1)


def _shift_prev(x):
    """x[k-1] with x[-1] = 0: prepend a zero block, drop the last."""
    z = jnp.zeros_like(x[:1])
    return jnp.concatenate([z, x[:-1]], axis=0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BCRFactor:
    """Per-level b-independent elimination state (outermost level first).
    ``ls[p]``: Cholesky factors of the level-p odd diagonal blocks;
    ``wls[p]``/``wrs[p]``: substitution maps ``D⁻¹E_even`` / ``D⁻¹E_oddᵀ``;
    ``elefts[p]``/``erights[p]``: the level's coupling blocks (needed by
    the RHS reduction); ``l0``: the final single-block factor."""

    ls: tuple
    wls: tuple
    wrs: tuple
    elefts: tuple
    erights: tuple
    l0: jax.Array
    n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def nb(self) -> int:
        return int(self.l0.shape[0])

    @property
    def m_padded(self) -> int:
        return 2 * int(self.ls[0].shape[0]) if self.ls else 1


def _pad_pow2(D, E):
    m, nb = int(D.shape[0]), int(D.shape[1])
    p = 1
    while p < m:
        p *= 2
    if p != m:
        eye = jnp.broadcast_to(jnp.eye(nb, dtype=D.dtype), (p - m, nb, nb))
        D = jnp.concatenate([D, eye], axis=0)
    # E[i] couples block i+1 <- i; pad to length p with zeros (no coupling
    # into the identity pad region).
    if int(E.shape[0]) != p:
        ez = jnp.zeros((p - int(E.shape[0]), nb, nb), dtype=D.dtype)
        E = jnp.concatenate([E, ez], axis=0)
    return D, E


@jax.jit
def factor_bcr(D: jax.Array, E: jax.Array) -> "BCRFactor":
    """Eliminate odd blocks level by level (all batched). The level loop is
    a Python loop over statically halving shapes — it unrolls at trace
    time into log2(m) batched stages."""
    with factor_precision():
        return _factor_bcr(D, E)


def _factor_bcr(D, E):
    n = int(D.shape[0]) * int(D.shape[1])
    D, E = _pad_pow2(D, E)
    ls, wls, wrs, elefts, erights = [], [], [], [], []
    while int(D.shape[0]) > 1:
        dodd = D[1::2]
        eleft = E[0::2]                    # E_{2k} (couples odd 2k+1 <- 2k)
        eright = E[1::2]                   # E_{2k+1} (couples 2k+2 <- 2k+1)
        l = jnp.linalg.cholesky(dodd)
        wl = _chol_solve(l, eleft)                        # D⁻¹ E_{2k}
        wr = _chol_solve(l, jnp.swapaxes(eright, 1, 2))   # D⁻¹ E_{2k+1}ᵀ
        ls.append(l), wls.append(wl), wrs.append(wr)
        elefts.append(eleft), erights.append(eright)
        D = (D[0::2] - _mm(_shift_prev(eright), _shift_prev(wr))
             - _mm(jnp.swapaxes(eleft, 1, 2), wl))
        E = -_mm(eright, wl)                # E'_k = -E_{2k+1} Wl_k
        E = jnp.concatenate([E[:-1], jnp.zeros_like(E[:1])], axis=0)
    l0 = jnp.linalg.cholesky(D[0])
    return BCRFactor(ls=tuple(ls), wls=tuple(wls), wrs=tuple(wrs),
                     elefts=tuple(elefts), erights=tuple(erights),
                     l0=l0, n=n)


@jax.jit
def solve_bcr(fac: BCRFactor, b: jax.Array) -> jax.Array:
    """Solve from a prepared factor; ``b`` is (m_padded, nb, k) blocks."""
    # forward: reduce the RHS level by level, keeping each level's z
    zs = []
    for l, eleft, eright in zip(fac.ls, fac.elefts, fac.erights):
        z = _chol_solve(l, b[1::2])
        zs.append(z)
        b = (b[0::2] - _mm(_shift_prev(eright), _shift_prev(z))
             - _mm(jnp.swapaxes(eleft, 1, 2), z))
    x = _chol_solve(fac.l0[None], b[0][None])          # (1, nb, k)
    # backward: interleave the recovered odd blocks at each level
    for wl, wr, z in zip(reversed(fac.wls), reversed(fac.wrs),
                         reversed(zs)):
        x_next = jnp.concatenate([x[1:], jnp.zeros_like(x[:1])], axis=0)
        x_odd = z - _mm(wl, x) - _mm(wr, x_next)
        x = jnp.stack([x, x_odd], axis=1).reshape(
            2 * x.shape[0], *x.shape[1:])
    return x


@jax.jit
def _tridiag_matvec(D: jax.Array, E: jax.Array, x: jax.Array) -> jax.Array:
    """Block-tridiagonal A·x on (m, nb, k) blocks; E padded to length m with
    a zero last coupling."""
    t = _mm(E, x)                                   # E_i x_i -> row i+1
    up = jnp.concatenate([x[1:], jnp.zeros_like(x[:1])], axis=0)
    return _mm(D, x) + _shift_prev(t) + _mm(jnp.swapaxes(E, 1, 2), up)


@jax.jit
def _solve_refined(fac: BCRFactor, D, E, blocks, steps: int = 1):
    x = solve_bcr(fac, blocks)
    # Iterative refinement: the odd-even elimination order costs a little
    # f32 accuracy on ill-conditioned systems vs the sequential scan; one
    # residual-correction pass (a batched matvec + one more O(log m) solve)
    # recovers it and then some.
    for _ in range(steps):
        r = blocks - _tridiag_matvec(D, E, x)
        x = x + solve_bcr(fac, r)
    return x


@dataclasses.dataclass
class BCRSolver:
    """Prepared BCR solver for one banded SPD matrix. Keeps the (padded)
    block operands for the refinement matvec."""

    fac: BCRFactor
    D: jax.Array
    E: jax.Array
    n: int
    nb: int

    def solve(self, b) -> jax.Array:
        m = -(-self.n // self.nb)
        blocks, squeeze = _blocked_rhs(b, self.n, m, self.nb)
        mp = self.fac.m_padded
        if mp != m:
            pad = jnp.zeros((mp - m,) + blocks.shape[1:], blocks.dtype)
            blocks = jnp.concatenate([blocks, pad], axis=0)
        x = _solve_refined(self.fac, self.D, self.E, blocks)
        x = x.reshape(mp * self.nb, -1)[: self.n]
        return x[:, 0] if squeeze else x


def prepare_bcr(a: CSR, nb: int | None = None) -> BCRSolver:
    """Factor a symmetric banded SPD CSR for O(log m)-depth solves."""
    if nb is None:
        nb = block_size_for(bandwidth(a), a.rows)
    D, E = band_blocks(a, nb)
    D, E = _pad_pow2(jnp.asarray(D), jnp.asarray(E))
    fac = factor_bcr(D, E)
    return BCRSolver(fac=fac, D=D, E=E, n=a.rows, nb=nb)
