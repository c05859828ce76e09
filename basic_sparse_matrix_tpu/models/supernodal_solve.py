"""Supernodal triangular solves: ``L y = b`` and ``Lᵀ x = y`` by panels.

The level-set solve (:mod:`models.sparse_triangular`) schedules single rows
and pads every level to the global maximum row count and row length. For a
supernodal factor that is hopeless: the k=33 3D-Laplacian factor has 3,639
row levels, up to 3,398 rows in one level and rows up to 4,716 entries long,
so the padded tables alone would take ~470 GB. Here the unit is the
supernode panel the factorization already produced:

* forward, supernode-etree levels ascending: ``y_s = T_s⁻¹ x_s`` (a batched
  dense triangular solve over the level's panels), then
  ``x[below_s] -= B_s · y_s`` (one batched product + scatter-add);
* backward, levels descending: ``x_s = T_s⁻ᵀ (y_s - B_sᵀ · x[below_s])``.

``T_s`` (the panel's dense lower triangle) and ``B_s`` (its below-block) are
read from the factor's flat CSC values at positions rebuilt in register from
per-panel column pointers, as the numeric phase does. Runs of consecutive
levels are padded to one shape and ``lax.scan``-ned as a group, so the
program size follows the number of groups, not the number of levels: on
the GPU, compiling each group costs far more than running it.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import factor_precision
from .supernodal import (XLA_COMPILE_OPTIONS, SupernodalSchedule,
                         _panel_positions)

@dataclasses.dataclass(frozen=True)
class PanelSolveSchedule:
    """Packed per-group tables (leading axis g = the group's level count):
    ``cp`` (g,S,W) column pointers of each panel's columns (``nnz_l`` =
    the zero scratch slot for padding), ``width`` (g,S) panel widths,
    ``nbelow`` (g,S) below-row counts, ``cols`` (g,S,W) the panel's column
    indices and ``below`` (g,S,R) its below rows (``n`` = the zero scratch
    row of the right-hand side for padding)."""

    flat: jax.Array
    # static: per group, per table: (flat offset, shape)
    layout: Tuple = dataclasses.field(metadata=dict(static=True))
    nnz_l: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))


jax.tree_util.register_dataclass(
    PanelSolveSchedule, data_fields=["flat"],
    meta_fields=["layout", "nnz_l", "n"])


# A run of consecutive levels is padded to its largest (pow2-rounded)
# level while the padded volume stays within this factor of the levels'
# own: the solves move little data, and each group is one more stretch of
# program to compile (k=33 3D Laplacian: 288 levels in 19 groups).
_GROUP_SLACK = 4
# Right-hand-side counts are padded to a multiple of this, so that 1 to 8
# columns share one compiled program.
_RHS_BUCKET = 8


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _group_levels(dims):
    """Greedy runs of consecutive levels; ``dims`` are (S, W, R) per level.
    Returns [(first, last + 1, (S, W, R) of the run)]."""
    def vol(d, count=1):
        return count * d[0] * d[1] * (d[1] + d[2])

    runs, start, cur, own = [], 0, dims[0], vol(dims[0])
    for i in range(1, len(dims)):
        m = tuple(max(x, y) for x, y in zip(cur, dims[i]))
        if vol(m, i - start + 1) <= _GROUP_SLACK * (own + vol(dims[i])):
            cur, own = m, own + vol(dims[i])
        else:
            runs.append((start, i, cur))
            start, cur, own = i, dims[i], vol(dims[i])
    if dims:
        runs.append((start, len(dims), cur))
    return runs


def build_panel_solve(sched: SupernodalSchedule) -> PanelSolveSchedule:
    """Host analysis: per supernode-etree level, padded panel tables; runs
    of consecutive levels padded to one shape and stacked into groups.
    Needs the instance :func:`models.supernodal.analyze_supernodal`
    returned."""
    col_ptr, csc_rows, c0, c1, slevel = sched.panel_parts
    n, scratch = sched.n, sched.nnz_l
    nlev = int(slevel.max()) + 1 if slevel.size else 0
    sns_of = [np.nonzero(slevel == lv)[0] for lv in range(nlev)]
    nb_of = [(col_ptr[c1[s]] - col_ptr[c1[s] - 1] - 1).astype(np.int64)
             for s in sns_of]
    dims = [(_pow2(s.size), _pow2((c1[s] - c0[s]).max()),
             _pow2(max(nb.max(), 1))) for s, nb in zip(sns_of, nb_of)]

    chunks, layout, off = [], [], 0
    for lo, hi, (S, W, R) in _group_levels(dims):
        tabs = [np.full((hi - lo, S, W), scratch, np.int64),   # cp
                np.zeros((hi - lo, S), np.int64),              # width
                np.zeros((hi - lo, S), np.int64),              # nbelow
                np.full((hi - lo, S, W), n, np.int64),         # cols
                np.full((hi - lo, S, R), n, np.int64)]         # below
        for g, lv in enumerate(range(lo, hi)):
            for k, s in enumerate(sns_of[lv]):
                a, b = int(c0[s]), int(c1[s])
                tabs[0][g, k, :b - a] = col_ptr[a:b]
                tabs[1][g, k] = b - a
                tabs[2][g, k] = nb_of[lv][k]
                tabs[3][g, k, :b - a] = np.arange(a, b)
                tabs[4][g, k, :nb_of[lv][k]] = csc_rows[
                    col_ptr[b - 1] + 1:col_ptr[b]]
        lay = []
        for t in tabs:
            chunks.append(t.astype(np.int32).ravel())
            lay.append((off, t.shape))
            off += t.size
        layout.append(tuple(lay))
    flat = (np.concatenate(chunks) if chunks
            else np.zeros((0,), np.int32))
    return PanelSolveSchedule(flat=jnp.asarray(flat), layout=tuple(layout),
                              nnz_l=scratch, n=n)


def _group_tabs(ps: PanelSolveSchedule, gi: int):
    out = []
    for off, shape in ps.layout[gi]:
        size = int(np.prod(shape))
        out.append(jax.lax.slice(ps.flat, (off,), (off + size,))
                   .reshape(shape))
    return out


def _panels(lvals, cp, width, nbelow, R: int, scratch: int):
    """Dense panel blocks of one level: T (S,W,W) lower triangle with a
    unit diagonal on padded columns, B (S,R,W) below-block (zero-padded)."""
    W = cp.shape[1]
    tv = jnp.arange(W, dtype=jnp.int32)[None, :] < width[:, None]
    tp, bp = _panel_positions(cp, nbelow, tv, R, scratch)
    eye = jnp.eye(W, dtype=lvals.dtype)
    T = lvals[tp] + jnp.where(tv[:, :, None] & tv[:, None, :], 0.0, eye)
    return T, lvals[bp]


def _fwd_step(lvals, x, tabs, scratch: int, n: int):
    cp, width, nbelow, cols, below = tabs
    T, B = _panels(lvals, cp, width, nbelow, below.shape[1], scratch)
    with factor_precision():
        ys = jax.scipy.linalg.solve_triangular(T, x[cols], lower=True)
    x = x.at[cols].set(ys)
    x = x.at[below].add(-jnp.einsum("srw,swm->srm", B, ys,
                                    precision=jax.lax.Precision.HIGHEST))
    return x.at[n].set(0.0)


def _bwd_step(lvals, x, tabs, scratch: int, n: int):
    cp, width, nbelow, cols, below = tabs
    T, B = _panels(lvals, cp, width, nbelow, below.shape[1], scratch)
    rhs = x[cols] - jnp.einsum("srw,srm->swm", B, x[below],
                               precision=jax.lax.Precision.HIGHEST)
    with factor_precision():
        xs = jax.scipy.linalg.solve_triangular(T, rhs, lower=True, trans=1)
    return x.at[cols].set(xs).at[n].set(0.0)


def _run(step, lvals, x, tabs, scratch, n, reverse):
    if tabs[0].shape[0] == 1:
        return step(lvals, x, [t[0] for t in tabs], scratch, n)
    x, _ = jax.lax.scan(
        lambda xc, t: (step(lvals, xc, t, scratch, n), None), x, tabs,
        reverse=reverse)
    return x


@partial(jax.jit, static_argnames=("transpose",),
         compiler_options=XLA_COMPILE_OPTIONS)
def _solve_panels(ps: PanelSolveSchedule, lvals: jax.Array, b: jax.Array,
                  transpose: bool) -> jax.Array:
    scratch, n = ps.nnz_l, ps.n
    lvals = jnp.concatenate([lvals.astype(jnp.float32),
                             jnp.zeros((1,), jnp.float32)])
    x = jnp.concatenate([b.astype(jnp.float32),
                         jnp.zeros((1,) + b.shape[1:], jnp.float32)])
    order = range(len(ps.layout))
    for gi in (reversed(order) if transpose else order):
        x = _run(_bwd_step if transpose else _fwd_step, lvals, x,
                 _group_tabs(ps, gi), scratch, n, transpose)
    return x[:n]


def solve_panels(ps: PanelSolveSchedule, lvals: jax.Array, b: jax.Array,
                 transpose: bool = False) -> jax.Array:
    """``L⁻¹ b`` (or ``L⁻ᵀ b`` with ``transpose``) for the supernodal
    factor ``lvals`` (flat CSC values, length ``nnz_l``); ``b`` is (n, m)."""
    m = b.shape[1]
    pad = -m % _RHS_BUCKET
    if pad:
        b = jnp.pad(b, ((0, 0), (0, pad)))
    return _solve_panels(ps, lvals, b, transpose)[:, :m]
