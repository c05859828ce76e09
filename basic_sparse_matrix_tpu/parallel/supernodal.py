"""Distributed supernodal Cholesky (panel-granular D3).

The supernodal numeric phase (:mod:`models.supernodal`) parallelises the
same way as the scalar scatter-list one (:mod:`parallel.cholesky`): within a
fan-in level, both the panel-update batch and the panel finalisations are
independent, so each device takes a slice of the level's update list and of
its panel list, and one ``psum`` per phase merges the disjoint
contributions. The per-update work here is a dense outer product —
this is the "fan-out elimination-tree schedule with column-panel broadcasts"
of BASELINE.json's north star, with the broadcast realised as the
psum-replicated factor value array. Tables are the COMPACT per-update
vectors (as in models.supernodal); full position arrays are rebuilt
in-register on each device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..models.supernodal import (
    SupernodalSchedule,
    _panel_positions,
    _upd_positions,
    analyze_supernodal,
    assemble_factor,
)
from ..ops.csr import CSR
from ..utils.config import factor_precision
from .mesh import ROWS


def _split(a: np.ndarray, num: int, pad_value) -> np.ndarray:
    """Pad axis 1 (the group's update/panel batch; axis 0 is the group's
    level count) to a multiple of ``num`` devices and expose the device
    axis: (g, M, ...) → (g, num, M/num, ...)."""
    g, m = a.shape[0], a.shape[1]
    pad = (-m) % num
    if pad:
        widths = [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)
        a = np.pad(a, widths, constant_values=pad_value)
    m = a.shape[1]
    return a.reshape((g, num, m // num) + a.shape[2:])


def factorize_supernodal_sharded(sched: SupernodalSchedule, a_values,
                                 mesh, *, chunk_groups: int = 0
                                 ) -> jax.Array:
    """Distributed numeric phase. ``chunk_groups > 0`` bounds each compiled
    program to that many schedule groups (the distributed analogue of the
    single-device ``_groups_chunk`` protocol): ND schedules at n >= 10^4
    have hundreds of distinct-shape groups, and one whole-schedule program
    is an unboundedly large XLA compile; chunked programs carry the
    replicated factor array between launches instead."""
    num = mesh.shape[ROWS]
    scratch = sched.nnz_l
    n = sched.n

    def split_all(tables, pad_value):
        return tuple(jnp.asarray(_split(np.asarray(t), num, pad_value))
                     for t in tables)

    # Pad values chosen so padded update/panel slots are fully masked by
    # the position rebuilders: meta 0 → ni = nj = 0; top_valid False.
    ubase = split_all(sched.upd_base, scratch)
    umeta = split_all(sched.upd_meta, 0)
    uir = split_all(sched.upd_irows, n)
    uib = split_all(sched.upd_ibelow, 0)
    ujr = split_all(sched.upd_jrows, n)
    ujcp = split_all(sched.upd_jcp, scratch)
    pcp = split_all(sched.panel_cp, scratch)
    pr = split_all(sched.panel_r, 0)
    tval = split_all(sched.top_valid, False)
    nlev = len(ubase)
    a_vals = jnp.asarray(a_values)

    def level_step(lvals, tabs, R):
        base, meta, irows, ibelow, jrows, jcp, cp, r_tab, tv = tabs
        ga, gb, sc = _upd_positions(base, meta, irows, ibelow, jrows, jcp,
                                    scratch)
        # local slice of this level's panel-update batch → psum merge
        A = lvals[ga]
        B = lvals[gb]
        U = jnp.einsum("uiw,ujw->uij", A, B,
                       precision=jax.lax.Precision.HIGHEST)
        delta = jnp.zeros_like(lvals).at[sc].add(-U)
        delta = delta.at[-1].set(0.0)
        lvals = lvals + jax.lax.psum(delta, ROWS)

        # local slice of this level's panels → psum publish
        tp, bp = _panel_positions(cp, r_tab, tv, R, scratch)
        T = lvals[tp]
        eye = jnp.eye(T.shape[-1], dtype=T.dtype)
        Tsym = T + jnp.where(tv[:, :, None] & tv[:, None, :], 0.0, eye)
        Bp = lvals[bp]
        with factor_precision():
            Lt = jnp.linalg.cholesky(
                Tsym + jnp.triu(jnp.swapaxes(Tsym, 1, 2), 1))
            Bn = jax.scipy.linalg.solve_triangular(
                Lt, jnp.swapaxes(Bp, 1, 2), lower=True)
        Bn = jnp.swapaxes(Bn, 1, 2)
        newT = jnp.where(jnp.isfinite(Lt), jnp.tril(Lt), 0.0)
        fix = jnp.zeros_like(lvals).at[tp].add(newT - T)
        fix = fix.at[bp].add(Bn - Bp)
        fix = fix.at[-1].set(0.0)
        return lvals + jax.lax.psum(fix, ROWS)

    def run_group(lvals, tabs, R):
        """``tabs`` local: (g, M_local, ...) — scan over g levels."""
        if tabs[0].shape[0] == 1:
            return level_step(lvals, tuple(t[0] for t in tabs), R)
        lvals, _ = jax.lax.scan(
            lambda lv, t, _R=R: (level_step(lv, t, _R), None),
            lvals, tabs)
        return lvals

    all_tabs = (ubase, umeta, uir, uib, ujr, ujcp, pcp, pr, tval)

    if not chunk_groups:
        def body(ubase, umeta, uir, uib, ujr, ujcp, pcp, pr, tval, a_vals):
            lvals = jnp.zeros(sched.nnz_l + 1, dtype=jnp.float32)
            lvals = lvals.at[sched.a_src_pos].add(
                a_vals[sched.a_vals_idx].astype(jnp.float32))
            local_tabs = (ubase, umeta, uir, uib, ujr, ujcp, pcp, pr,
                          tval)
            for gi in range(nlev):
                # local tables: (g, 1, M_local, ...) → drop the local
                # device axis, scan over g
                tabs = tuple(t[gi][:, 0]
                             for t in local_tabs)
                lvals = run_group(lvals, tabs, sched.panel_rmax[gi])
            return lvals[:-1]

        spec = lambda tables: tuple(P(None, ROWS)          # noqa: E731
                                    for _ in tables)
        f = jax.shard_map(
            body, mesh=mesh,
            in_specs=(spec(ubase), spec(umeta), spec(uir), spec(uib),
                      spec(ujr), spec(ujcp), spec(pcp), spec(pr),
                      spec(tval), P()),
            out_specs=P(),
        )
        return jax.jit(f)(ubase, umeta, uir, uib, ujr, ujcp, pcp, pr,
                          tval, a_vals)

    # ---- chunked: one bounded program per chunk_groups schedule groups ----
    def init_body(a_vals):
        lvals = jnp.zeros(sched.nnz_l + 1, dtype=jnp.float32)
        return lvals.at[sched.a_src_pos].add(
            a_vals[sched.a_vals_idx].astype(jnp.float32))

    lvals = jax.jit(jax.shard_map(init_body, mesh=mesh, in_specs=(P(),),
                                  out_specs=P()))(a_vals)

    for c0 in range(0, nlev, chunk_groups):
        gis = tuple(range(c0, min(c0 + chunk_groups, nlev)))
        tabs_chunk = tuple(tuple(tab[gi] for tab in all_tabs)
                           for gi in gis)
        rs = tuple(sched.panel_rmax[gi] for gi in gis)

        def chunk_body(tabs_chunk, lvals, _rs=rs):
            for tabs, R in zip(tabs_chunk, _rs):
                lvals = run_group(lvals, tuple(t[:, 0] for t in tabs), R)
            return lvals

        in_specs = (tuple(tuple(P(None, ROWS) for _ in all_tabs)
                          for _ in gis), P())
        f = jax.shard_map(chunk_body, mesh=mesh, in_specs=in_specs,
                          out_specs=P())
        lvals = jax.jit(f)(tabs_chunk, lvals)
    return lvals[:-1]


def cholesky_supernodal_distributed(a: CSR, mesh, *, relax: int = 0,
                                    chunk_groups: int = 0) -> CSR:
    sched = analyze_supernodal(a, relax=relax)
    lvals = np.asarray(
        jax.device_get(factorize_supernodal_sharded(
            sched, a.values, mesh, chunk_groups=chunk_groups)))
    return assemble_factor(a, lvals, sched)
