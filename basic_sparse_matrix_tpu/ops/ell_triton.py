"""ELL SpMM as one Pallas kernel through Triton (GPU).

One program per (row block, column tile of B): it loads its rows' column
indices and values, gathers the matching rows of B one ELL slot at a time,
accumulates in registers and stores its tile of C once. The XLA path
(:func:`ops.ell._spmm_ell_unrolled` and its bounded variants) expresses the
same gather+FMA as fused loops and stays the plain reference; on one H100
this kernel is faster at 100k and 1M rows x 32/row x 512 RHS (``PERF.md``),
so :func:`ops.ell.spmm_ell` takes it on the GPU. It has no gradient rule;
neither has the rest of the library.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .ell import ELL


def _kernel(cols_ref, vals_ref, b_ref, o_ref, *, width: int):
    acc = jnp.zeros(o_ref.shape, jnp.float32)
    for k in range(width):
        idx = cols_ref[:, k]                       # (block_rows,)
        v = vals_ref[:, k].astype(jnp.float32)
        acc += v[:, None] * b_ref[idx, :].astype(jnp.float32)
    o_ref[...] = acc.astype(o_ref.dtype)


@functools.partial(jax.jit, static_argnames=(
    "block_rows", "block_cols", "num_warps", "interpret"))
def spmm_ell_triton(ell: ELL, b: jax.Array, *, block_rows: int = 32,
                    block_cols: int = 128, num_warps: int = 4,
                    interpret: bool = False) -> jax.Array:
    """``out[r] = Σ_k vals[r,k]·B[cols[r,k]]``. Rows and B's columns are
    padded up to the block sizes (powers of two, as Triton requires)."""
    rows, width = ell.cols.shape
    k_rows, n_rhs = b.shape
    rp = -(-rows // block_rows) * block_rows
    npad = -(-n_rhs // block_cols) * block_cols
    cols, vals = ell.cols, ell.vals.astype(b.dtype)
    if rp != rows:
        cols = jnp.pad(cols, ((0, rp - rows), (0, 0)))
        vals = jnp.pad(vals, ((0, rp - rows), (0, 0)))
    if npad != n_rhs:
        b = jnp.pad(b, ((0, 0), (0, npad - n_rhs)))
    out = pl.pallas_call(
        functools.partial(_kernel, width=width),
        out_shape=jax.ShapeDtypeStruct((rp, npad), b.dtype),
        grid=(rp // block_rows, npad // block_cols),
        in_specs=[
            pl.BlockSpec((block_rows, width), lambda i, j: (i, 0)),
            pl.BlockSpec((block_rows, width), lambda i, j: (i, 0)),
            pl.BlockSpec((k_rows, block_cols), lambda i, j: (0, j)),
        ],
        out_specs=pl.BlockSpec((block_rows, block_cols),
                               lambda i, j: (i, j)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="spmm_ell_triton",
    )(cols, vals, b)
    return out[:rows, :n_rhs]
