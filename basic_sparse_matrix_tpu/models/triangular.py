"""Triangular solves (forward / backward substitution).

Reference counterparts: ``forward_substitution`` / ``backward_substitution``
(``/root/reference/src/lib.rs:28-65``) — scalar loops over (column of b, row),
walking compact CSR rows, with the diagonal assumed last (forward, lib.rs:41)
or first (backward, lib.rs:57-60) in each row's storage. Multi-RHS is an outer
Python loop over b's columns.

Device-native: the dense path uses XLA's blocked ``solve_triangular`` with the
RHS columns as one batched dim (no outer loop). The sparse level-scheduled
path (for large factors, where densifying is wasteful) lives in
``sparse_triangular.py`` on top of the native runtime's level-set analysis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..ops.csr import CSR
from ..ops.dense import Dense
from ..utils.errors import IncorrectDimensions, check


@functools.partial(jax.jit, static_argnums=(2,))
def solve_triangular_dense(l: jax.Array, b: jax.Array,
                           lower: bool) -> jax.Array:
    return jsl.solve_triangular(l.astype(jnp.float32),
                                b.astype(jnp.float32), lower=lower)


def _as_array(b) -> jax.Array:
    if isinstance(b, Dense):
        return b.array
    b = jnp.asarray(b)
    return b[:, None] if b.ndim == 1 else b


def forward_substitution(l: CSR, b) -> jax.Array:
    """Solve ``L y = b`` (L lower-triangular) — reference
    ``forward_substitution`` (lib.rs:28-46). Multi-RHS batched, not looped."""
    rhs = _as_array(b)
    check(rhs.shape[0] == l.rows, IncorrectDimensions,
          f"forward_substitution: {l.dims} vs rhs {rhs.shape}")
    return solve_triangular_dense(l.todense(), rhs, True)


def backward_substitution(u: CSR, y) -> jax.Array:
    """Solve ``U x = y`` (U upper-triangular) — reference
    ``backward_substitution`` (lib.rs:49-65)."""
    rhs = _as_array(y)
    check(rhs.shape[0] == u.rows, IncorrectDimensions,
          f"backward_substitution: {u.dims} vs rhs {rhs.shape}")
    return solve_triangular_dense(u.todense(), rhs, False)
