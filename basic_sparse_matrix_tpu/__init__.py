"""basic_sparse_matrix_tpu — a sparse linear-algebra framework in JAX.

A from-scratch JAX/XLA re-expression of the capability surface of the
reference crate ``jamieapps101/Basic_Sparse_Matrix`` (mounted at
``/root/reference``): CSR/COO construction, transpose, reductions, sparse
add/sub, SpMM/SpMV/SpGEMM, Cholesky, QR, QR-iteration eigenvalues, and the
Cholesky triangular-solve pipeline — plus the layers the reference lacks:
density-dispatched device paths for the hot operations, a
sharding/collectives layer for multi-device/multi-host scale-out, a native
(C++) host runtime for symbolic analysis, and a roofline bench harness.

Layer map (mirrors SURVEY.md §1):
* ``utils``    — shape/dtype vocabulary + error model (reference util.rs)
* ``ops``      — storage formats and device ops (reference sparse.rs L1/L2)
* ``models``   — factorizations and solvers (reference sparse.rs L3, lib.rs L4)
* ``parallel`` — mesh/sharding/collectives (new; no reference counterpart)
* ``runtime``  — native symbolic analysis, checkpointing, profiling (new)
"""

from .models import (
    DirectSolver,
    SparseOperator,
    backward_substitution,
    cholesky,
    cholesky_auto,
    cholesky_decomp,
    cholesky_dense,
    cholesky_sparse,
    eigen_values,
    eigen_values_sym,
    forward_substitution,
    pcg_solve,
    prepare_direct,
    qr_decomp,
    solve,
    solve_auto,
    solve_dense,
    solve_sparse,
)
from .ops import (
    COO,
    CSR,
    CsrEntry,
    Dense,
    DenseS,
    add_sparse,
    l2_norm,
    mul_dense,
    mul_scalar,
    mul_sparse,
    mul_vector,
    spgemm,
    spmm,
    spmv,
    sub_sparse,
    sum_elements,
    transpose,
)
from .utils import (
    IncorrectDimensions,
    MatDim,
    MatErr,
    NonSquareMatrix,
    OutOfBounds,
    PaddingSizeSmallerThanOriginal,
)

__version__ = "0.1.0"
