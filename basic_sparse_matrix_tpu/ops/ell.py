"""ELL (padded-row) sparse format — the hypersparse SpMM fast path.

SURVEY.md §7's "padded block-ELL / segment-tiled layouts". For matrices with
low row-length variance, padding every row to the max length turns SpMM into
``gather + batched reduce`` with **no scatter**: each output row is written
once, and the gathers fuse into the multiply-add chain. The residual cost is
the random row-gather of B itself.

Dispatch policy (``ops.spmm.spmm_auto``): ELL is used below the dense
density threshold whenever the padding overhead ``rows·width / nnz`` stays
under ``config.ell_max_overhead``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .csr import CSR


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded row-major sparse layout: ``cols[r, k]``/``vals[r, k]`` hold the
    k-th stored entry of row r; padding slots have ``col = 0, val = 0``."""

    cols: jax.Array   # (rows, width) int32
    vals: jax.Array   # (rows, width)
    n_cols: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_rows(self) -> int:
        return int(self.cols.shape[0])

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])


def csr_to_ell(a: CSR) -> ELL:
    """Host-side CSR → ELL conversion (O(nnz) numpy)."""
    cols, vals = ell_host_arrays(a)
    return ELL(cols=jnp.asarray(cols), vals=jnp.asarray(vals),
               n_cols=a.cols)


def ell_host_arrays(a: CSR, pad_rows_to: int = 1):
    """Host numpy ``(cols, vals)`` of the ELL layout, with the row count
    padded up to a multiple of ``pad_rows_to`` by empty rows."""
    indptr, indices, values = a.numpy()
    lens = np.diff(indptr)
    width = max(int(lens.max()) if a.rows else 0, 1)
    n_rows = -(-a.rows // pad_rows_to) * pad_rows_to
    cols = np.zeros((n_rows, width), dtype=np.int32)
    vals = np.zeros((n_rows, width), dtype=values.dtype)
    if a.stored and (lens == width).all():
        # uniform rows (hypersparse generators): a reshape, no scatter
        cols[: a.rows] = np.asarray(indices).reshape(a.rows, width)
        vals[: a.rows] = np.asarray(values).reshape(a.rows, width)
        return cols, vals
    rows = np.repeat(np.arange(a.rows), lens)
    offs = np.arange(a.stored) - np.repeat(indptr[:-1], lens)
    cols[rows, offs] = indices
    vals[rows, offs] = values
    return cols, vals


# Budgets are sized for an 80 GB card, of which a JAX process takes three
# quarters. The gathered intermediate of the einsum formulation is
# (rows, width, n_rhs) and materialises in device memory, so large problems
# run in row chunks of at most this many bytes.
INTERMEDIATE_BUDGET_BYTES = 4 << 30

# The unrolled-width formulation keeps each gather term a separate
# (rows, n_rhs) temp, and XLA may schedule up to ~width of them live
# (32 x (1M, 512) f32 is 64 GB), so gate on the estimated live-temp
# footprint: a fifth of the card's memory.
UNROLL_TEMP_BUDGET_BYTES = 16 << 30
UNROLL_MAX_WIDTH = 64


@jax.jit
def _spmm_ell_direct(ell: ELL, b: jax.Array) -> jax.Array:
    gathered = b[ell.cols]  # (rows, width, n_rhs)
    return jnp.einsum(
        "rp,rpn->rn", ell.vals.astype(b.dtype), gathered,
        precision=jax.lax.Precision.HIGHEST,
    )


@jax.jit
def _spmm_ell_unrolled(ell: ELL, b: jax.Array) -> jax.Array:
    """Sum over the width dimension as ``width`` separate gather+FMA terms.

    ``einsum('rp,rpn->rn', vals, b[cols])`` is a dot_general, and XLA cannot
    fuse a gather into a matmul contraction — the (rows, width, n_rhs)
    intermediate materialises in device memory, tripling gather traffic.
    Expressed as elementwise multiply-adds the gathers fuse into the
    accumulation chain."""
    out = ell.vals[:, 0, None].astype(b.dtype) * b[ell.cols[:, 0], :]
    for k in range(1, ell.width):
        out = out + ell.vals[:, k, None].astype(b.dtype) * b[ell.cols[:, k], :]
    return out


@functools.partial(jax.jit, static_argnums=(2, 3))
def _spmm_ell_barriered(ell: ELL, b: jax.Array, group: int,
                        bf16_gather: bool = False) -> jax.Array:
    """Width-unrolled gather+FMA with an ``optimization_barrier`` between
    groups of ``group`` terms.

    The plain unroll lets XLA schedule every gather concurrently — at
    1M×32×512 the live (rows, n_rhs) temps total 64 GB. Threading
    (acc, B) through a barrier after each group forces later gathers to
    wait (they depend on the post-barrier B), bounding live temps to one
    group while keeping the within-group gather→FMA fusion that the
    chunked-einsum fallback lacks.

    ``bf16_gather`` (opt-in, config ``ell_gather_bf16``) gathers B rows in
    bfloat16 with f32 accumulation — halves gather traffic and temp sizes
    at a B-quantisation accuracy cost."""
    acc_dt = jnp.float32 if bf16_gather else b.dtype
    bb = b.astype(jnp.bfloat16) if bf16_gather else b
    out = None
    ngroups = -(-ell.width // group)
    for q in range(ngroups):
        for k in range(q * group, min((q + 1) * group, ell.width)):
            term = (ell.vals[:, k, None].astype(acc_dt)
                    * bb[ell.cols[:, k]].astype(acc_dt))
            out = term if out is None else out + term
        if q + 1 < ngroups:
            out, bb = jax.lax.optimization_barrier((out, bb))
    return out.astype(b.dtype)


def _chunk_rows(ell: ELL, n_rhs: int) -> int:
    per_row = ell.width * n_rhs * 4
    return max(1, INTERMEDIATE_BUDGET_BYTES // max(per_row, 1))


@functools.partial(jax.jit, static_argnums=(2,))
def _spmm_ell_chunked(ell: ELL, b: jax.Array, chunk: int) -> jax.Array:
    rows = ell.n_rows
    nchunks = -(-rows // chunk)
    pad = nchunks * chunk - rows
    cols = jnp.pad(ell.cols, ((0, pad), (0, 0)))
    vals = jnp.pad(ell.vals, ((0, pad), (0, 0)))
    cols = cols.reshape(nchunks, chunk, ell.width)
    vals = vals.reshape(nchunks, chunk, ell.width)

    def one(cv):
        c, v = cv
        return jnp.einsum(
            "rp,rpn->rn", v.astype(b.dtype), b[c],
            precision=jax.lax.Precision.HIGHEST,
        )

    out = jax.lax.map(one, (cols, vals))
    return out.reshape(nchunks * chunk, b.shape[1])[:rows]


def use_triton_kernel(width: int, n_rhs: int, dtype, backend: str) -> bool:
    """Whether :func:`spmm_ell` takes the Pallas-Triton kernel: on the GPU,
    for float32 with at least one full 128-column tile of B (the shapes it
    was measured to win at) and rows short enough to unroll."""
    return (backend == "gpu" and jnp.dtype(dtype) == jnp.float32
            and n_rhs >= 128 and width <= UNROLL_MAX_WIDTH)


def spmm_ell(ell: ELL, b: jax.Array) -> jax.Array:
    """SpMM via gather + per-row reduce: ``out[r] = Σ_k vals[r,k]·B[cols[r,k]]``.
    Padding slots contribute ``0 · B[0]``. On the GPU, wide float32 B goes
    through the Pallas-Triton kernel (:mod:`ops.ell_triton`). Otherwise the
    fastest XLA path: width-unrolled gather+FMA (fusable, no
    (rows, width, n_rhs) intermediate) while the live-temp estimate fits;
    else the barrier-grouped unroll (live temps bounded to one group, fusion
    kept within it); else the chunked einsum formulation (wide rows, where
    unrolling stops making sense)."""
    if use_triton_kernel(ell.width, int(b.shape[1]), b.dtype,
                         jax.default_backend()):
        from .ell_triton import spmm_ell_triton

        return spmm_ell_triton(ell, b)
    return spmm_ell_xla(ell, b)


def spmm_ell_xla(ell: ELL, b: jax.Array) -> jax.Array:
    """The XLA formulations of :func:`spmm_ell`, on any backend; the plain
    reference the Triton kernel is checked against."""
    n_rhs = int(b.shape[1])
    temp_bytes = ell.width * ell.n_rows * n_rhs * 4
    if ell.width <= UNROLL_MAX_WIDTH:
        if temp_bytes <= UNROLL_TEMP_BUDGET_BYTES:
            return _spmm_ell_unrolled(ell, b)
        from ..utils.config import get_config

        bf16 = bool(get_config().ell_gather_bf16)
        per_term = ell.n_rows * n_rhs * (2 if bf16 else 4)
        group = UNROLL_TEMP_BUDGET_BYTES // max(per_term, 1)
        if group >= 2:
            return _spmm_ell_barriered(ell, b, int(group), bf16)
    chunk = _chunk_rows(ell, n_rhs)
    if chunk >= ell.n_rows:
        return _spmm_ell_direct(ell, b)
    return _spmm_ell_chunked(ell, b, chunk)


@jax.jit
def spmv_ell(ell: ELL, x: jax.Array) -> jax.Array:
    """SpMV over ELL: width-unrolled gather+FMA (same fusion rationale as
    :func:`_spmm_ell_unrolled`; the (rows, width) intermediate is small for
    SpMV but the unrolled form still fuses the gathers) when width is
    moderate, else one gathered product + row reduce."""
    if ell.width <= UNROLL_MAX_WIDTH:
        out = ell.vals[:, 0].astype(x.dtype) * x[ell.cols[:, 0]]
        for k in range(1, ell.width):
            out = out + ell.vals[:, k].astype(x.dtype) * x[ell.cols[:, k]]
        return out
    prod = ell.vals.astype(x.dtype) * x[ell.cols]
    return jnp.sum(prod, axis=1)


def ell_overhead(a: CSR) -> float:
    """Padding overhead factor: stored slots after padding / true stored."""
    indptr, _, _ = a.numpy()
    lens = np.diff(indptr)
    width = max(int(lens.max()) if a.rows else 0, 1)
    return a.rows * width / max(a.stored, 1)


def spmm_ell_from_csr(a: CSR, b: jax.Array) -> jax.Array:
    """CSR entry point with memoised ELL conversion."""
    ell = getattr(a, "_ell_cache", None)
    if ell is None:
        ell = csr_to_ell(a)
        object.__setattr__(a, "_ell_cache", ell)
    return spmm_ell(ell, b)
