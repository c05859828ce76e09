"""Banded (block-tridiagonal) SPD Cholesky factorization and solve.

Reference counterpart: ``cholesky_decomp`` / ``solve``
(``/root/reference/src/sparse.rs:682-714``, ``/root/reference/src/
lib.rs:11-24``) — value-level parity only; the schedule here is a
device-native design with no reference analogue.

After an RCM preordering, the benchmark-family matrices (2D/3D Laplacians,
``bcsstk``-like stiffness patterns) are *banded*: ``a[i, j] == 0`` for
``|i - j| > bw``. Partitioning into ``m = ceil(n / nb)`` blocks of size
``nb >= bw`` makes A block-tridiagonal, and Cholesky preserves the band.
The factorization then collapses from hundreds of irregular fan-in levels
(the supernodal schedule at n=4096 RCM has 455) to ``m`` *identically
shaped* dense steps — one ``lax.scan`` of dense potrf/trsm/syrk ops:

    L_0 = chol(D_0)
    F_{i-1} = E_{i-1} · L_{i-1}^{-T}          (trsm)
    L_i = chol(D_i − F_{i-1} F_{i-1}ᵀ)        (syrk + potrf)

and both triangular solves are block-bidiagonal scans. Regular shapes
compile to few programs and batch well; this path takes that to its limit
— *one* shape for the whole factorization.

The tail block is padded with an identity diagonal so every scan step is
the same (nb, nb) shape; padded rows of the RHS are zero and decouple.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np

from ..ops.csr import CSR
from ..utils.config import factor_precision, matmul_precision
from ..utils.errors import IncorrectDimensions, NonSquareMatrix, check


from ..ops.reorder import bandwidth  # noqa: E402  (host O(nnz) band scan)


def block_size_for(bw: int, n: int | None = None) -> int:
    """Multiple-of-8 block size covering half-bandwidth ``bw``.

    Any ``nb >= bw`` is valid; larger blocks trade flops (O(n·nb²) total)
    for fewer sequential scan steps (m = n/nb, each with fixed dispatch
    latency inside the scan). For very narrow bands the step count would
    dominate, so the block is floored to keep m ≲ 128."""
    nb = max(8, -(-max(bw, 1) // 8) * 8)
    if n is not None:
        target = -(-n // 128)                # block size for ~128 scan steps
        target = -(-target // 8) * 8         # rounded up to the 8-alignment
        nb = max(nb, min(target, 128))
    return nb


def banded_block_choice(a: CSR) -> int | None:
    """Dispatch predicate: the block size to use for ``a``, or ``None`` when
    the banded path is not profitable (band too wide, storage too large, or
    too few block rows to beat the dense/supernodal paths)."""
    from ..utils.config import get_config

    cfg = get_config()
    if cfg.banded_max_block <= 0:
        return None
    nb = block_size_for(bandwidth(a), a.rows)
    if nb > cfg.banded_max_block:
        return None
    if 8 * a.rows * nb > cfg.banded_max_bytes:  # 2 blocks/row · nb² · 4 B
        return None
    if a.rows < nb * cfg.banded_min_steps:
        return None
    return nb


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BandedFactor:
    """Block-bidiagonal Cholesky factor: ``L[i]`` (nb, nb) lower-triangular
    diagonal blocks, ``F[i]`` (nb, nb) subdiagonal blocks coupling block
    ``i+1`` to block ``i``. Trailing pad rows carry an identity diagonal."""

    L: jax.Array  # (m, nb, nb)
    F: jax.Array  # (m-1, nb, nb)
    n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def nb(self) -> int:
        return int(self.L.shape[1])

    @property
    def m(self) -> int:
        return int(self.L.shape[0])


def band_blocks(a: CSR, nb: int):
    """Host: block-tridiagonal (D, E) numpy blocks of symmetric banded A.

    ``D[i]`` is the i-th (nb, nb) diagonal block (full symmetric), ``E[i]``
    the subdiagonal block coupling block i+1 to block i. Requires
    ``bandwidth(a) <= nb``; raises ``IncorrectDimensions`` otherwise."""
    check(a.rows == a.cols, NonSquareMatrix, "band_blocks needs square A")
    n = a.rows
    m = -(-n // nb)
    indptr, indices, values = a.numpy()
    rows = np.repeat(np.arange(n), np.diff(indptr))
    cols = indices
    bi, bj = rows // nb, cols // nb
    check(bool(np.all(np.abs(bi - bj) <= 1)), IncorrectDimensions,
          f"band_blocks: entries outside block-tridiagonal band (nb={nb})")
    D = np.zeros((m, nb, nb), dtype=np.float32)
    E = np.zeros((max(m - 1, 0), nb, nb), dtype=np.float32)
    diag = bi == bj
    D[bi[diag], rows[diag] % nb, cols[diag] % nb] = values[diag]
    sub = bi == bj + 1
    E[bj[sub], rows[sub] % nb, cols[sub] % nb] = values[sub]
    # pad tail rows with a decoupled identity so chol stays defined
    for r in range(n, m * nb):
        D[m - 1, r % nb, r % nb] = 1.0
    return D, E


@jax.jit
def cholesky_banded_blocks(D: jax.Array, E: jax.Array):
    """Block-tridiagonal Cholesky as one ``lax.scan`` over block rows."""
    with factor_precision():
        return _cholesky_banded_blocks(D, E)


def _cholesky_banded_blocks(D, E):
    prec = matmul_precision()
    l0 = jnp.linalg.cholesky(D[0])

    def step(l_prev, de):
        d, e = de
        # F = E · L_prevᵀ⁻¹: solve L_prev Yᵀ = Eᵀ, F = Y
        f = jsl.solve_triangular(l_prev, e.T, lower=True).T
        s = d - jnp.matmul(f, f.T, precision=prec)
        l = jnp.linalg.cholesky(s)
        return l, (l, f)

    _, (ls, fs) = jax.lax.scan(step, l0, (D[1:], E))
    return jnp.concatenate([l0[None], ls], axis=0), fs


@jax.jit
def solve_banded_blocks(L: jax.Array, F: jax.Array, b: jax.Array):
    """Solve ``(L Lᵀ) x = b`` with block-bidiagonal L; ``b`` is (m, nb, k)."""
    prec = matmul_precision()
    y0 = jsl.solve_triangular(L[0], b[0], lower=True)

    def fstep(y_prev, lfb):
        l, f, bi = lfb
        y = jsl.solve_triangular(
            l, bi - jnp.matmul(f, y_prev, precision=prec), lower=True)
        return y, y

    _, ys = jax.lax.scan(fstep, y0, (L[1:], F, b[1:]))
    y = jnp.concatenate([y0[None], ys], axis=0)

    xm = jsl.solve_triangular(L[-1], y[-1], lower=True, trans=1)

    def bstep(x_next, lfy):
        l, f, yi = lfy
        x = jsl.solve_triangular(
            l, yi - jnp.matmul(f.T, x_next, precision=prec),
            lower=True, trans=1)
        return x, x

    _, xs = jax.lax.scan(bstep, xm, (L[:-1], F, y[:-1]), reverse=True)
    return jnp.concatenate([xs, xm[None]], axis=0)


def factor_banded(a: CSR, nb: int | None = None) -> BandedFactor:
    """Factor a symmetric banded SPD CSR into a :class:`BandedFactor`."""
    if nb is None:
        nb = block_size_for(bandwidth(a))
    D, E = band_blocks(a, nb)
    L, F = cholesky_banded_blocks(jnp.asarray(D), jnp.asarray(E))
    return BandedFactor(L=L, F=F, n=a.rows)


def _blocked_rhs(b, n: int, m: int, nb: int):
    b = jnp.asarray(b, dtype=jnp.float32)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    check(b.shape[0] == n, IncorrectDimensions,
          f"banded solve: A n={n} vs b {b.shape}")
    pad = m * nb - n
    b = jnp.pad(b, ((0, pad), (0, 0)))
    return b.reshape(m, nb, b.shape[1]), squeeze


def solve_factored_banded(fac: BandedFactor, b) -> jax.Array:
    """Solve ``A x = b`` from a prepared :class:`BandedFactor`."""
    blocks, squeeze = _blocked_rhs(b, fac.n, fac.m, fac.nb)
    x = solve_banded_blocks(fac.L, fac.F, blocks)
    x = x.reshape(fac.m * fac.nb, -1)[: fac.n]
    return x[:, 0] if squeeze else x


def solve_banded(a: CSR, b, nb: int | None = None) -> jax.Array:
    """Factor + solve for symmetric banded SPD ``A`` (no reordering)."""
    return solve_factored_banded(factor_banded(a, nb), b)


def assemble_factor_csr(fac: BandedFactor) -> CSR:
    """Host: lay the block factor into a lower-triangular CSR (exact zeros
    dropped, matching the dense path's storage behaviour)."""
    L = np.asarray(jax.device_get(fac.L))
    F = np.asarray(jax.device_get(fac.F))
    m, nb, n = fac.m, fac.nb, fac.n
    rs, cs, vs = [], [], []
    tr, tc = np.tril_indices(nb)
    for i in range(m):
        rs.append(i * nb + tr)
        cs.append(i * nb + tc)
        vs.append(L[i][tr, tc])
    fr, fc = np.unravel_index(np.arange(nb * nb), (nb, nb))
    for i in range(m - 1):
        rs.append((i + 1) * nb + fr)
        cs.append(i * nb + fc)
        vs.append(F[i].ravel())
    rows = np.concatenate(rs)
    cols = np.concatenate(cs)
    vals = np.concatenate(vs)
    keep = (rows < n) & (cols < n)
    return CSR.from_coo_arrays((n, n), rows[keep], cols[keep], vals[keep],
                               sum_duplicates=False, drop_zeros=True)
