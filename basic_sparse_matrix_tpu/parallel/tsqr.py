"""Distributed TSQR (communication-avoiding tall-skinny QR).

No reference counterpart at this scale — the reference's ``qr_decomp``
(``/root/reference/src/sparse.rs:716-756``) is a single-threaded
Householder deflation loop. This is the CAQR factorization shaped for a
device mesh: each device runs one local blocked QR over its row shard
(:func:`models.qr.tsqr_dense` semantics), the tiny (n, n) R factors ride
ONE ``all_gather``, every device redundantly factors the stacked
(num·n, n) matrix (deterministic — replicated R), and the local Q is
corrected by the device's slice of the tree Q. Communication volume is
``num · n²`` floats total, independent of m.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ..ops.csr import CSR
from ..utils.errors import IncorrectDimensions, check
from .mesh import ROWS


def tsqr_sharded(a, mesh) -> Tuple[jax.Array, jax.Array]:
    """Reduced QR of a tall (m, n) operand, rows sharded over
    ``mesh[ROWS]``. Returns (Q row-sharded (m, n), R replicated (n, n)).
    ``a`` may be a dense array or a CSR (densified — Q is dense anyway)."""
    arr = a.todense() if isinstance(a, CSR) else jnp.asarray(a)
    m, n = arr.shape
    num = mesh.shape[ROWS]
    check(m >= n * num, IncorrectDimensions,
          f"tsqr_sharded needs rows >= cols*devices, got {arr.shape} "
          f"on {num} shards")
    pad = (-m) % num
    arr = jnp.pad(arr.astype(jnp.float32), ((0, pad), (0, 0)))
    arr = jax.device_put(arr, NamedSharding(mesh, P(ROWS)))
    prec = jax.lax.Precision.HIGHEST

    def body(ab):
        ql, rl = jnp.linalg.qr(ab)                       # local block QR
        rs = jax.lax.all_gather(rl, ROWS)                # (num, n, n)
        q2, r = jnp.linalg.qr(rs.reshape(num * n, n))    # redundant tree
        idx = jax.lax.axis_index(ROWS)
        myq2 = jax.lax.dynamic_slice(q2, (idx * n, 0), (n, n))
        # r is computed identically on every device from the all_gathered
        # Rs, but shard_map cannot statically infer that replication —
        # emit it row-sharded (each device contributes its copy) and take
        # the first copy outside.
        return jnp.matmul(ql, myq2, precision=prec), r

    f = jax.shard_map(body, mesh=mesh, in_specs=P(ROWS),
                      out_specs=(P(ROWS), P(ROWS)))
    q, r = jax.jit(f)(arr)
    return q[:m], r[:n]
