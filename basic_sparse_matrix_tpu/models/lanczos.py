"""Lanczos eigensolver for large sparse symmetric matrices.

The reference's ``eigen_values`` (``/root/reference/src/sparse.rs:758-774``)
is an unshifted dense QR iteration; this framework ports that surface in
``models/qr.py`` but guards it with the densify byte budget — a 200k×200k
sparse operand has no dense path at all. Lanczos is the device-native answer
for that regime: the only touch of A is one SpMV per step (the ELL
gather+FMA kernel when the padding overhead permits, same dispatch as PCG),
and everything else is (k, n) × (n,) matmuls.

Design notes
------------
* Static ``k`` steps as one ``lax.scan`` — the whole Krylov build compiles
  to a single program; no host round-trips per step.
* Full reorthogonalisation every step (classical Gram-Schmidt applied
  twice against the stored basis). Plain three-term Lanczos loses
  orthogonality in f32 after a few dozen steps and produces spurious ghost
  eigenvalue copies; two dense (k, n) matmuls per step are cheap
  and buy exact-basis behaviour. Rows of V beyond the current step are zero,
  so no masking is needed — zero rows project to zero.
* Breakdown (β ≈ 0 — an invariant subspace was found) is handled in-graph:
  the offending β is zeroed so the tridiagonal T decouples, and the stalled
  direction restarts from a deterministic pseudo-random vector re-projected
  against the basis; Ritz values of the converged block are unaffected.
* The Ritz values are ``eigvalsh`` of the k×k tridiagonal T — O(k³) on a
  matrix that fits in registers, not O(n³) on the densified operand.

Extremal Ritz values converge first; interior ones are approximations
unless k approaches n (at k == n the spectrum is exact up to roundoff).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.csr import CSR
from ..utils.errors import NonSquareMatrix, check


@dataclasses.dataclass(frozen=True)
class LanczosSetup:
    """Host-side preparation mirroring ``PCGSetup``: keep A, and an ELL
    view when the padding overhead permits so each step's SpMV runs the
    scatter-free unrolled gather+FMA kernel."""

    a: CSR
    ell: Optional["ELL"] = None

    @staticmethod
    def build(a: CSR) -> "LanczosSetup":
        check(a.rows == a.cols, NonSquareMatrix,
              f"lanczos needs square matrix, got {a.dims}")
        from ..ops.ell import csr_to_ell, ell_overhead
        from ..utils.config import get_config

        ell = None
        if a.stored and ell_overhead(a) <= get_config().ell_max_overhead:
            ell = csr_to_ell(a)
        return LanczosSetup(a=a, ell=ell)


jax.tree_util.register_dataclass(
    LanczosSetup, data_fields=["a", "ell"], meta_fields=[],
)


def _matvec(setup: LanczosSetup, x: jax.Array) -> jax.Array:
    if setup.ell is not None:
        from ..ops.ell import spmv_ell

        return spmv_ell(setup.ell, x)
    from ..ops.spmm import spmv

    return spmv(setup.a, x)


@partial(jax.jit, static_argnums=(2,))
def _lanczos_scan(setup: LanczosSetup, v0: jax.Array, k: int
                  ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """k Lanczos steps with full reorthogonalisation.

    Returns (alphas (k,), betas (k-1,), V (k, n)) with V the orthonormal
    Krylov basis. β below the breakdown threshold is stored as 0 (T
    decouples) and the basis restarts from a fresh re-orthogonalised
    direction.
    """
    n = v0.shape[0]
    eps = jnp.float32(1e-7)

    v0 = v0 / jnp.maximum(jnp.linalg.norm(v0), 1e-30)
    V = jnp.zeros((k, n), jnp.float32).at[0].set(v0)

    def reproject(V, w):
        # CGS2: two classical Gram-Schmidt passes against the whole stored
        # basis. Zero (unfilled) rows of V contribute nothing.
        w = w - V.T @ (V @ w)
        return w - V.T @ (V @ w)

    def step(carry, j):
        V, = carry
        vj = V[j]
        w = _matvec(setup, vj)
        alpha = jnp.vdot(vj, w)
        w = reproject(V, w)
        beta = jnp.linalg.norm(w)
        anorm = jnp.maximum(jnp.abs(alpha), 1.0)
        broke = beta <= eps * anorm

        # Deterministic restart direction for the breakdown case, built
        # without host randomness so the scan body stays pure.
        fresh = jnp.sin(
            (jnp.arange(n, dtype=jnp.float32) + 1.0) * (1.0 + j)
        )
        fresh = reproject(V, fresh)
        fresh = fresh / jnp.maximum(jnp.linalg.norm(fresh), 1e-30)

        v_next = jnp.where(broke, fresh, w / jnp.maximum(beta, 1e-30))
        beta = jnp.where(broke, 0.0, beta)
        V = jax.lax.cond(
            j + 1 < k,
            lambda V: V.at[j + 1].set(v_next),
            lambda V: V,
            V,
        )
        return (V,), (alpha, beta)

    (V,), (alphas, betas) = jax.lax.scan(
        step, (V,), jnp.arange(k, dtype=jnp.int32))
    return alphas, betas[:-1], V


@partial(jax.jit, static_argnums=(2,))
def _ritz_values(setup: LanczosSetup, v0: jax.Array, k: int) -> jax.Array:
    alphas, betas, _ = _lanczos_scan(setup, v0, k)
    t = jnp.diag(alphas)
    if k > 1:
        t = t + jnp.diag(betas, 1) + jnp.diag(betas, -1)
    return jnp.linalg.eigvalsh(t)


def eigen_values_lanczos(a: CSR, k: int = 32, *,
                         setup: Optional[LanczosSetup] = None,
                         seed: int = 0) -> jax.Array:
    """k Ritz values (ascending) of symmetric ``a`` from a k-step fully
    reorthogonalised Lanczos run. Extremal values converge first; at
    ``k == a.rows`` the full spectrum is exact up to f32 roundoff.

    The sparse-regime counterpart of ``models.qr.eigen_values_sym`` —
    no densification, O(k·(spmv + k·n)) work, compiles to one program.
    Pass a prebuilt ``setup`` to amortise the ELL conversion across calls.
    """
    if setup is None:
        setup = LanczosSetup.build(a)
    check(a.rows == a.cols, NonSquareMatrix,
          f"eigen_values_lanczos requires square matrix, got {a.dims}")
    k = int(min(k, a.rows))
    if k < 1:
        raise ValueError("eigen_values_lanczos: k must be >= 1")
    v0 = jax.random.normal(jax.random.PRNGKey(seed), (a.rows,), jnp.float32)
    return _ritz_values(setup, v0, k)


def extremal_eigen_values(a: CSR, k: int = 32, *,
                          setup: Optional[LanczosSetup] = None,
                          seed: int = 0) -> Tuple[float, float]:
    """(λ_min, λ_max) estimates — the first Ritz pair to converge."""
    ritz = eigen_values_lanczos(a, k, setup=setup, seed=seed)
    return float(ritz[0]), float(ritz[-1])


def condition_estimate(a: CSR, k: int = 32, *,
                       setup: Optional[LanczosSetup] = None,
                       seed: int = 0) -> float:
    """2-norm condition estimate λ_max/λ_min for SPD ``a`` — the quantity
    that predicts PCG iteration counts and when ``BCRSolver``'s iterative
    refinement pass earns its keep. Returns ``inf`` when the smallest Ritz
    value is not resolved as positive (indefinite or k too small)."""
    lo, hi = extremal_eigen_values(a, k, setup=setup, seed=seed)
    if lo <= 0.0:
        return float("inf")
    return hi / lo
