"""Worker process for the real multi-process multihost test.

Launched by ``tests/test_multihost.py::test_two_process_spmm`` as N
subprocesses. Each process initialises the JAX distributed runtime against a
localhost coordinator, builds ONLY its own row block of a global CSR
(``build_global_sharded_csr``'s ``process_count > 1`` assembly path —
which no single-process test executes), runs the row-sharded SpMM
over the global 2-host mesh, and validates its addressable output shards
against the dense oracle.

Usage: python multihost_worker.py <process_id> <num_processes> <port>
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
)

import jax  # noqa: E402, F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from basic_sparse_matrix_tpu.parallel.multihost import initialize  # noqa: E402

initialize(coordinator_address=f"localhost:{port}", num_processes=nproc,
           process_id=pid)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from basic_sparse_matrix_tpu import CSR  # noqa: E402
from basic_sparse_matrix_tpu.parallel.multihost import (  # noqa: E402
    RowBlockSpec,
    build_global_sharded_csr,
    global_row_mesh,
    local_row_block,
    weak_scaling_report,
)
from basic_sparse_matrix_tpu.parallel.sharded import shard_csr  # noqa: E402
from basic_sparse_matrix_tpu.parallel.spmm import spmm_sharded  # noqa: E402

assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, jax.devices()
assert len(jax.local_devices()) == 4

rows, cols = 96, 40
rng = np.random.default_rng(0)  # same seed everywhere: global test oracle
dense = ((rng.random((rows, cols)) < 0.25)
         * rng.standard_normal((rows, cols))).astype(np.float32)
b = np.asarray(
    np.random.default_rng(1).standard_normal((cols, 3)), dtype=np.float32)


def builder(spec: RowBlockSpec) -> CSR:
    return CSR.from_dense(dense[spec.row_start:spec.row_end])


# Global per-device nnz padding agreement (each process derives the same
# value from the shared generator — stands in for an analytic bound).
nnz_max = max(
    shard_csr(builder(local_row_block(rows, cols, process_id=p,
                                      process_count=nproc)),
              4).indices.shape[1]
    for p in range(nproc)
)

mesh = global_row_mesh()
spec = local_row_block(rows, cols)
sa = build_global_sharded_csr(spec, builder, mesh,
                              nnz_max_per_device=nnz_max)
y = spmm_sharded(sa, jnp.asarray(b), mesh)

expect = dense @ b
pad = sa.padded_rows - rows
if pad:
    expect = np.vstack([expect, np.zeros((pad, b.shape[1]), np.float32)])
n_checked = 0
for shard in y.addressable_shards:
    sl = shard.index[0]
    np.testing.assert_allclose(np.asarray(shard.data), expect[sl],
                               rtol=1e-4, atol=1e-4)
    n_checked += 1
assert n_checked == 4, n_checked

rec = weak_scaling_report(seconds=1.0, nnz_per_host=sa.indices.shape[1] * 4,
                          baseline_seconds_1host=1.0)
assert rec["hosts"] == nproc

print(f"proc {pid}/{nproc} OK ({n_checked} shards validated)", flush=True)
