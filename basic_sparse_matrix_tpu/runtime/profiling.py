"""Profiling, metrics, and roofline analysis.

The reference's only observability is criterion wall-time benches and stray
``println!``s (SURVEY.md §5). Here: structured per-op metrics (nnz/s,
GFLOP/s, bytes moved), a roofline calculator against the device's published
peaks (one table, keyed by ``device_kind``), timer contexts, and
``jax.profiler`` trace hooks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import time
from typing import Dict, Iterator, Optional

logger = logging.getLogger("basic_sparse_matrix_tpu")


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Published peak rates of one device, the roofline denominators."""

    name: str
    hbm_bw: float       # device-memory bytes/s
    tf32: float         # FLOP/s, dense tensor-core TF32
    f32: float          # FLOP/s, float32 outside the tensor cores
    source: str


# One entry per device_kind the program has run on. A device that is not
# here is an error, never a default: its numbers would be invented.
PEAKS: Dict[str, ChipSpec] = {
    "NVIDIA H100 80GB HBM3": ChipSpec(
        name="NVIDIA H100 80GB HBM3", hbm_bw=3.35e12, tf32=4.95e14,
        f32=6.7e13,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5 column "
               "(dense rates, 700 W)"),
}


def peak_spec(device_kind: Optional[str] = None) -> ChipSpec:
    """Peak table lookup by ``device_kind`` (default: the first JAX
    device's). Raises ``KeyError`` for a device with no entry."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak rates for device_kind {device_kind!r}; add its data "
            f"sheet numbers to runtime.profiling.PEAKS") from None


@dataclasses.dataclass
class OpMetrics:
    op: str
    seconds: float
    flops: float = 0.0
    bytes_moved: float = 0.0
    nnz: int = 0

    @property
    def gflops_per_s(self) -> float:
        return self.flops / self.seconds / 1e9 if self.seconds else 0.0

    @property
    def nnz_per_s(self) -> float:
        return self.nnz / self.seconds if self.seconds else 0.0

    def roofline_fraction(self, chip: ChipSpec) -> float:
        """Achieved fraction of speed-of-light = t_bound / t_measured with
        t_bound = max(memory time, float32 compute time)."""
        t_mem = self.bytes_moved / chip.hbm_bw
        t_flop = self.flops / chip.f32
        t_bound = max(t_mem, t_flop)
        return t_bound / self.seconds if self.seconds else 0.0

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["gflops_per_s"] = self.gflops_per_s
        d["nnz_per_s"] = self.nnz_per_s
        return json.dumps(d)


_registry: Dict[str, OpMetrics] = {}


def record(m: OpMetrics) -> OpMetrics:
    _registry[m.op] = m
    logger.info("metrics %s", m.to_json())
    return m


def all_metrics() -> Dict[str, OpMetrics]:
    return dict(_registry)


@contextlib.contextmanager
def timed(op: str, *, flops: float = 0.0, bytes_moved: float = 0.0,
          nnz: int = 0) -> Iterator[OpMetrics]:
    """Wall-clock timer context that records an :class:`OpMetrics`. Callers
    must block on device results inside the context for honest numbers."""
    m = OpMetrics(op=op, seconds=0.0, flops=flops, bytes_moved=bytes_moved,
                  nnz=nnz)
    t0 = time.perf_counter()
    try:
        yield m
    finally:
        m.seconds = time.perf_counter() - t0
        record(m)


@contextlib.contextmanager
def trace(name: str):
    """``jax.profiler`` annotation (no-op if the profiler is unavailable)."""
    try:
        import jax.profiler

        with jax.profiler.TraceAnnotation(name):
            yield
    except Exception:
        yield


def spmm_cost(nnz: int, n_rhs: int, rows: int, cols: int,
              dtype_bytes: int = 4) -> Dict[str, float]:
    """Roofline cost model for gather-style SpMM: every stored entry reads
    one RHS row and the output is written once."""
    flops = 2.0 * nnz * n_rhs
    bytes_moved = (
        nnz * (dtype_bytes + 4)               # values + col indices
        + min(nnz, cols) * n_rhs * dtype_bytes  # RHS rows touched (≥ once)
        + rows * n_rhs * dtype_bytes          # output
    )
    return {"flops": flops, "bytes_moved": bytes_moved}
