"""Device mesh helpers.

No reference counterpart — the reference crate is single-threaded,
single-process (SURVEY.md §2, "Parallelism inventory: none"). This layer is
specified by BASELINE.json's north star: CSR matrices row-partitioned across
devices/hosts, dense RHS panels exchanged with XLA collectives.

Axis conventions used throughout ``parallel/``:
* ``"rows"`` — partitions matrix rows (the sparse analogue of tensor/sequence
  parallelism: the core dimension that scales).
* ``"cols"`` — partitions dense RHS columns (the data-parallel axis: multi-RHS
  batches are independent).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

ROWS = "rows"
COLS = "cols"


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (ROWS, COLS),
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    With no ``shape``, uses a 1D row mesh over every device. 2D shapes lay
    ``rows`` along the first axis.
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),)
        axis_names = axis_names[: 1]
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names[: len(shape)]))


def row_mesh(num: Optional[int] = None) -> Mesh:
    """1D mesh over ``num`` (default: all) devices, axis ``"rows"``."""
    devices = jax.devices()
    num = len(devices) if num is None else num
    return make_mesh((num,), (ROWS,), devices)
