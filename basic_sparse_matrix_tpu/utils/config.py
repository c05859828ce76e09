"""Configuration system.

The reference has no config surface at all — its only knobs are function
arguments and Cargo build profiles (SURVEY.md §5). Here a frozen dataclass
carries the framework-wide knobs (tile sizes, dtype policy, dispatch
thresholds, mesh shape) with env-var overrides (``BSM_*``) and an argparse
helper for the bench/driver scripts.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Tuple

from .errors import ConfigError


# Values accepted by the choice fields; anything else raises ConfigError.
CHOICES = {
    "supernodal_gather": ("auto", "element", "window"),
    "supernodal_scatter": ("auto", "element", "delta"),
    "ordering": ("auto", "rcm", "nd", "natural"),
    "banded_solver": ("bcr", "scan"),
    "merge_numeric": ("chunked", "planned"),
    "spgemm_numeric": ("planned", "chunked", "mergetree", "rowgather",
                       "auto"),
    "matmul_precision": ("default", "high", "highest"),
}


@dataclasses.dataclass(frozen=True)
class Config:
    # SpMM density ladder (ops.spmm.spmm_auto): dense matmul at or above
    # this density while the densified operand stays under the bytes
    # guard; the ELL gather+FMA path below it up to ell_max_overhead
    # padding; the gather/segment path otherwise.
    dense_dispatch_density: float = 0.005
    dense_dispatch_max_bytes: int = 2 << 30
    ell_max_overhead: float = 4.0   # padded-slots/true-nnz cap for ELL
    # Opt-in: gather RHS rows in bfloat16 (f32 accumulate) on the barriered
    # hypersparse path — halves gather bytes at a B-quantisation cost.
    ell_gather_bf16: int = 0
    dense_cholesky_max_n: int = 2048
    dense_cholesky_min_density: float = 0.05
    supernodal_relax: int = 8       # per-panel padding budget (amalgamation)
    # Max schedule groups compiled into one supernodal numeric program;
    # larger schedules run as a sequence of bounded programs with the
    # factor values device-resident (the 263-group n=35937 3D-ND schedule
    # OOM-killed the XLA compile process as a single program). 0 = always
    # one program.
    supernodal_groups_per_program: int = 48
    # Supernodal numeric READS: "element" (positions rebuilt in-register,
    # one gather per element), "window" (one dynamic-slice per contiguous
    # base+rank run — U·W reads instead of U·(I+J)·W), or "auto" (host
    # picks per level by run length; see models/supernodal).
    supernodal_gather: str = "auto"
    # Supernodal update SCATTER: "element" (per-element positions rebuilt
    # in-register — U·I·J scattered elements), "delta" (embed updates into
    # their target panels' dense trapezoid rects via one-hot matmuls,
    # merge per target, ONE affine rect scatter — St·Rd·Wt elements), or
    # "auto" (host picks per level by element count; see
    # models/supernodal).
    supernodal_scatter: str = "auto"
    ordering: str = "auto"          # fill ordering: auto|rcm|nd|natural
    # Banded (block-tridiagonal) factorization dispatch: used when the
    # (reordered) half-bandwidth fits a block size <= banded_max_block and
    # the dense band storage stays under banded_max_bytes. 0 disables.
    # The bytes guard, not block-size economics, is the binding
    # constraint; 2048 extends the banded/BCR tier to regular 3D patterns
    # at n >= 32k (bandwidth ~n^(2/3)).
    banded_max_block: int = 2048
    banded_max_bytes: int = 1 << 30
    banded_min_steps: int = 4       # need >= this many block rows to pay off
    # Banded backend: "bcr" (block cyclic reduction, O(log m) batched
    # stages) or "scan" (the sequential block scan).
    banded_solver: str = "bcr"
    # Planned-merge numeric phase: "chunked" (issue-coalesced row gathers +
    # one-hot select contracted as a matmul; see ops.elementwise
    # MERGE_CHUNK_W) or "planned" (two scalar inverse gathers).
    merge_numeric: str = "chunked"
    # spgemm_planned numeric phase: "chunked" (the merge kernel's
    # issue-coalescing generalised to Gustavson expansion — source-order
    # runs served by 4 aligned row gathers + one-hot select, then ONE
    # permutation gather to destination order) or "planned" (two scalar
    # gathers in destination order). "chunked" silently falls back per
    # plan when any expansion chunk spans >2 matched B rows (short-row
    # operands, where coalescing cannot help).
    # "mergetree": coalesced source-order products, then log2(max A row
    # nnz) rounds of pairwise sorted-stream merges on the ss_add chunk
    # kernel — no destination permutation and no scalar gathers at all;
    # falls back like "chunked" when streams are too short.
    # "rowgather": expansion products from a padded B-ELL via one ROW
    # gather per A entry (free reshape when B rows are uniform), then ONE
    # permutation gather to destination order — ~E + nnz_a gathers vs the
    # planned path's 2·E; falls back when B is too skewed to ELL-pad.
    spgemm_numeric: str = "planned"
    # Numerics. "highest" keeps float32 matmuls and factorizations in full
    # float32: at the default precision a GPU runs float32 products in
    # TF32 (about three decimal digits), which the direct solvers' and
    # the one-hot merges' exactness cannot afford.
    matmul_precision: str = "highest"
    solve_dtype: str = "float32"
    # Distribution.
    mesh_shape: Optional[Tuple[int, ...]] = None  # None = 1D over all devices

    def __post_init__(self):
        for name, allowed in CHOICES.items():
            value = getattr(self, name)
            if value not in allowed:
                raise ConfigError(
                    f"config {name}={value!r}: expected one of {allowed}")

    @staticmethod
    def from_env(base: Optional["Config"] = None) -> "Config":
        cfg = base or Config()
        overrides = {}
        for f in dataclasses.fields(Config):
            env = os.environ.get(f"BSM_{f.name.upper()}")
            if env is None:
                continue
            if f.type in ("int", int):
                overrides[f.name] = int(env)
            elif f.type in ("float", float):
                overrides[f.name] = float(env)
            else:
                overrides[f.name] = env
        return dataclasses.replace(cfg, **overrides)

    def add_cli_args(self, parser: argparse.ArgumentParser) -> None:
        for f in dataclasses.fields(Config):
            default = getattr(self, f.name)
            parser.add_argument(
                f"--{f.name.replace('_', '-')}", default=default,
                type=type(default) if default is not None else str,
            )

    @staticmethod
    def from_args(args: argparse.Namespace) -> "Config":
        names = {f.name for f in dataclasses.fields(Config)}
        return Config(**{k: v for k, v in vars(args).items() if k in names})


_config = Config.from_env()


def get_config() -> Config:
    return _config


def set_config(cfg: Config) -> None:
    global _config
    _config = cfg


def matmul_precision():
    """The configured jax matmul precision (lax.Precision)."""
    import jax

    return getattr(jax.lax.Precision, get_config().matmul_precision.upper())


def factor_precision():
    """Context manager that traces dense factorizations and triangular
    solves (``jnp.linalg.cholesky``, ``solve_triangular``, which take no
    ``precision`` argument) at the configured matmul precision."""
    import jax

    return jax.default_matmul_precision(get_config().matmul_precision)
