"""Distributed block cyclic reduction — a multi-chip banded direct solver.

No reference counterpart (the reference is single-threaded; SURVEY.md §2).
This distributes :mod:`models.bcr` over a 1D device mesh: blocks are
row-sharded contiguously, and each reduction level is embarrassingly
parallel except for ONE boundary block per device — the previous device's
last odd-block state — exchanged with a single ``ppermute`` per level
(overlapped by XLA with the batched block algebra). After
log2(m/ndev) local levels each device holds one block; the remaining
log2(ndev) levels run redundantly on every device from an ``all_gather``
of the ndev survivor blocks (tiny: ndev·nb² floats), avoiding a deep
cross-device dependency chain. Back-substitution mirrors the structure
with the opposite-direction boundary exchange.

The non-cyclic ``ppermute`` fills unpaired edges with zeros — exactly the
global boundary condition (no block before 0 / after m-1), so no masking
is needed anywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ..models import bcr as _bcr
from ..models.banded import band_blocks, bandwidth, block_size_for
from ..ops.csr import CSR
from ..utils.errors import IncorrectDimensions, check
from .mesh import ROWS


def _shift_from_prev_device(x, ndev):
    """Global ``x[k-1]`` over device-contiguous blocks: locally shift right,
    importing the previous device's last block (device 0 imports zeros)."""
    recv = jax.lax.ppermute(x[-1:], ROWS,
                            [(i, i + 1) for i in range(ndev - 1)])
    return jnp.concatenate([recv, x[:-1]], axis=0)


def _first_from_next_device(x, ndev):
    """The next device's first block (last device imports zeros)."""
    return jax.lax.ppermute(x[:1], ROWS,
                            [(i, i - 1) for i in range(1, ndev)])


def bcr_solve_sharded(D: jax.Array, E: jax.Array, b: jax.Array,
                      mesh) -> jax.Array:
    """Solve the block-tridiagonal SPD system with blocks sharded over the
    mesh's ``rows`` axis. ``D``/``E`` are (m, nb, nb) with ``E[i]`` coupling
    block i+1 to block i and ``E[m-1] = 0``; ``b`` is (m, nb, k). ``m`` must
    be ndev·2^q. Returns the (m, nb, k) solution, row-sharded."""
    ndev = mesh.shape[ROWS]
    m = int(D.shape[0])
    check(m % ndev == 0 and (m // ndev) & (m // ndev - 1) == 0,
          IncorrectDimensions,
          f"bcr_solve_sharded: m={m} must be ndev·2^q (ndev={ndev})")

    def body(dl, el, bl):
        saved = []
        # ---- local reduction: batched elimination + 3-block ppermute ----
        while int(dl.shape[0]) > 1:
            dodd, eleft, eright = dl[1::2], el[0::2], el[1::2]
            l = jnp.linalg.cholesky(dodd)
            wl = _bcr._chol_solve(l, eleft)
            wr = _bcr._chol_solve(l, jnp.swapaxes(eright, 1, 2))
            z = _bcr._chol_solve(l, bl[1::2])
            er_prev = _shift_from_prev_device(eright, ndev)
            wr_prev = _shift_from_prev_device(wr, ndev)
            z_prev = _shift_from_prev_device(z, ndev)
            elt = jnp.swapaxes(eleft, 1, 2)
            dl = (dl[0::2] - _bcr._mm(er_prev, wr_prev)
                  - _bcr._mm(elt, wl))
            bl = (bl[0::2] - _bcr._mm(er_prev, z_prev)
                  - _bcr._mm(elt, z))
            # E'_k = -E_{2k+1}·Wl_k; the last global coupling is already
            # zero because E[m-1] = 0 — no masking needed.
            el = -_bcr._mm(eright, wl)
            saved.append((wl, wr, z))
        # ---- cross-device tail: gather ndev survivors, finish redundantly
        dg = jax.lax.all_gather(dl, ROWS, tiled=True)
        eg = jax.lax.all_gather(el, ROWS, tiled=True)
        bg = jax.lax.all_gather(bl, ROWS, tiled=True)
        fac = _bcr.factor_bcr(dg, eg)
        if fac.m_padded != int(bg.shape[0]):    # non-power-of-two ndev
            pad = jnp.zeros((fac.m_padded - int(bg.shape[0]),)
                            + bg.shape[1:], bg.dtype)
            bg = jnp.concatenate([bg, pad], axis=0)
        xg = _bcr.solve_bcr(fac, bg)            # replicated survivor blocks
        me = jax.lax.axis_index(ROWS)
        x = jax.lax.dynamic_slice_in_dim(xg, me, 1)
        # ---- local back-substitution with the opposite boundary ----
        for wl, wr, z in reversed(saved):
            nxt = _first_from_next_device(x, ndev)
            x_next = jnp.concatenate([x[1:], nxt], axis=0)
            x_odd = z - _bcr._mm(wl, x) - _bcr._mm(wr, x_next)
            x = jnp.stack([x, x_odd], axis=1).reshape(
                2 * x.shape[0], *x.shape[1:])
        return x

    f = jax.shard_map(body, mesh=mesh,
                      in_specs=(P(ROWS), P(ROWS), P(ROWS)),
                      out_specs=P(ROWS))
    return jax.jit(f)(D, E, b)


def bcr_solve_sharded_csr(a: CSR, b, mesh, nb: int | None = None):
    """Host-side entry: block a banded SPD CSR, pad m to ndev·2^q, place the
    blocks row-sharded on the mesh, and solve. Returns (n, k) on host order."""
    ndev = mesh.shape[ROWS]
    if nb is None:
        nb = block_size_for(bandwidth(a), a.rows)
    D, E = band_blocks(a, nb)
    m = D.shape[0]
    mp = ndev
    while mp < m:
        mp *= 2
    if mp != m:
        pad = np.zeros((mp - m, nb, nb), dtype=D.dtype)
        pad[:, np.arange(nb), np.arange(nb)] = 1.0
        D = np.concatenate([D, pad], axis=0)
    ez = np.zeros((mp - E.shape[0], nb, nb), dtype=D.dtype)
    E = np.concatenate([E, ez], axis=0)
    b = np.asarray(b, dtype=np.float32)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    check(b.shape[0] == a.rows, IncorrectDimensions,
          f"bcr_solve_sharded: A n={a.rows} vs b {b.shape}")
    bb = np.zeros((mp * nb, b.shape[1]), dtype=np.float32)
    bb[: a.rows] = b
    bb = bb.reshape(mp, nb, b.shape[1])
    spec = NamedSharding(mesh, P(ROWS))
    D = jax.device_put(jnp.asarray(D), spec)
    E = jax.device_put(jnp.asarray(E), spec)
    bb = jax.device_put(jnp.asarray(bb), spec)
    x = bcr_solve_sharded(D, E, bb, mesh)
    x = np.asarray(x).reshape(mp * nb, -1)[: a.rows]
    return x[:, 0] if squeeze else x
