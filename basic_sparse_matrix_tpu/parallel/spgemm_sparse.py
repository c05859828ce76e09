"""Distributed sparse×sparse multiply (SpGEMM) over the row mesh.

Scales the reference's ``mul_sparse`` (`/root/reference/src/sparse.rs:601-635`,
a sequential per-output-cell merge) across devices: C = A·B row-partitions A, so
each device owns an independent Gustavson product ``C_s = A_s · B``. The
symbolic phase (exact output pattern + gather maps) runs per row block on the
host — embarrassingly parallel, one plan per shard, memoised by the caller by
reusing the returned plans — and the numeric phase for *all* shards is a
single ``shard_map``: one gather-multiply-scatter per device, values for
every block computed concurrently on the mesh. B is replicated (the usual
regime: A tall and row-sharded, B a smaller coupling matrix).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..ops.csr import CSR
from ..ops.spgemm import _SpgemmPlan
from ..utils.errors import IncorrectDimensions, check
from .mesh import ROWS


def plan_spgemm_sharded(a: CSR, b: CSR, num_shards: int) -> List[_SpgemmPlan]:
    """Host symbolic phase: one exact Gustavson plan per row block of A.
    Reuse across numeric calls with the same (pattern_a, pattern_b)."""
    check(a.cols == b.rows, IncorrectDimensions,
          f"spgemm_sharded: {a.dims} × {b.dims}")
    rps = -(-a.rows // num_shards)
    plans = []
    for s in range(num_shards):
        r0, r1 = s * rps, min((s + 1) * rps, a.rows)
        if r0 >= r1:
            block = CSR.empty((1, a.cols), dtype=a.dtype)
        else:
            block = a.take_submatrix((r0, 0), (r1, a.cols))
        plans.append(_SpgemmPlan(block, b))
    return plans


def spgemm_sharded(
    a: CSR, b: CSR, mesh,
    plans: Optional[List[_SpgemmPlan]] = None,
) -> CSR:
    """C = A·B with the numeric phase executed across the mesh. Returns the
    assembled global CSR (exact sparse output pattern, matches
    ``ops.spgemm.spgemm_planned``)."""
    num_shards = mesh.shape[ROWS]
    if plans is None:
        plans = plan_spgemm_sharded(a, b, num_shards)
    rps = -(-a.rows // num_shards)

    # Pad every shard's gather maps / A-value slice to common shapes so they
    # stack into mesh-shardable rectangles. Padded contributions are routed
    # to a discard slot (index nnz_max) and sliced off after the scatter.
    exp_max = max(max(int(p.dst.shape[0]) for p in plans), 1)
    nnz_max = max(max(p.nnz_c for p in plans), 1)
    ia = np.asarray(jax.device_get(a.indptr))
    va_bounds = []
    for s in range(num_shards):
        r0, r1 = s * rps, min((s + 1) * rps, a.rows)
        lo = int(ia[r0]) if r0 < a.rows else 0
        hi = int(ia[r1]) if r0 < a.rows else 0
        va_bounds.append((lo, hi))
    va_max = max(max(hi - lo for lo, hi in va_bounds), 1)

    def pad_map(arr, fill):
        arr = np.asarray(jax.device_get(arr))
        out = np.full(exp_max, fill, dtype=np.int32)
        out[: arr.shape[0]] = arr
        return out

    dst = np.stack([pad_map(p.dst, nnz_max) for p in plans])
    src_a = np.stack([pad_map(p.src_a, 0) for p in plans])
    src_b = np.stack([pad_map(p.src_b, 0) for p in plans])
    va = np.zeros((num_shards, va_max), dtype=np.float32)
    host_vals = np.asarray(jax.device_get(a.values))
    for s, (lo, hi) in enumerate(va_bounds):
        va[s, : hi - lo] = host_vals[lo:hi]

    def body(dst, src_a, src_b, va, vb):
        prod = va[0][src_a[0]] * vb[src_b[0]]
        out = jnp.zeros(nnz_max + 1, dtype=prod.dtype).at[dst[0]].add(prod)
        return out[None, :nnz_max]

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROWS), P(ROWS), P(ROWS), P(ROWS), P()),
        out_specs=P(ROWS),
    )
    stacked = jax.jit(f)(
        jnp.asarray(dst), jnp.asarray(src_a), jnp.asarray(src_b),
        jnp.asarray(va), jnp.asarray(b.values, jnp.float32),
    )

    # Assemble the global CSR from the per-shard exact patterns.
    out_vals = np.asarray(jax.device_get(stacked))
    vals, indices, indptr_parts = [], [], [np.zeros(1, dtype=np.int64)]
    base = 0
    for s, p in enumerate(plans):
        r0, r1 = s * rps, min((s + 1) * rps, a.rows)
        if r0 >= r1:
            continue
        vals.append(out_vals[s, : p.nnz_c])
        indices.append(np.asarray(jax.device_get(p.indices)))
        local_ptr = np.asarray(jax.device_get(p.indptr))[1 : r1 - r0 + 1]
        indptr_parts.append(local_ptr.astype(np.int64) + base)
        base += p.nnz_c
    indptr = np.concatenate(indptr_parts)
    return CSR(
        indptr=jnp.asarray(indptr.astype(np.int32)),
        indices=jnp.asarray(
            np.concatenate(indices) if indices
            else np.zeros(0, dtype=np.int32)),
        values=jnp.asarray(
            np.concatenate(vals) if vals
            else np.zeros(0, dtype=np.float32)),
        rows=a.rows, cols=b.cols,
    )
