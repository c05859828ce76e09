"""Dense matrix parity wrapper.

Reference counterparts: ``Dense<T>`` (``/root/reference/src/dense.rs:5-62``),
a **column-major** ``Vec<Vec<T>>`` whose ``from_data`` outer slices are
*columns* (dense.rs:21-29), and its const-generic stack twin ``DenseS``
(``/root/reference/src/dense_static.rs:5-68``).

On the device a dense matrix is just a row-major ``jnp.ndarray`` — XLA owns layout.
This wrapper exists purely for API/test parity: it preserves the reference's
column-oriented construction convention so reference test fixtures port
verbatim, while storing a plain (rows, cols) array inside. ``DenseS`` needs no
separate type — a static shape *is* a jit-specialised shape in JAX — so it is
an alias.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.shapes import MatDim


class Dense:
    """Thin column-convention wrapper over a row-major jnp array."""

    def __init__(self, array):
        self.array = jnp.asarray(array)
        assert self.array.ndim == 2

    # ------------------------------------------------------------------ #
    @staticmethod
    def new_default_with_dims(col_count: int, row_count: int,
                              dtype=jnp.float32) -> "Dense":
        """Zero matrix — reference ``new_default_with_dims``
        (dense.rs:13-15). NOTE the reference argument order: (cols, rows)."""
        return Dense(jnp.zeros((row_count, col_count), dtype=dtype))

    @staticmethod
    def new_with_dims(val, col_count: int, row_count: int) -> "Dense":
        """Constant fill — reference ``new_with_dims`` (dense.rs:17-19)."""
        return Dense(jnp.full((row_count, col_count), val))

    @staticmethod
    def from_data(cols) -> "Dense":
        """Column-major construction: ``cols[i]`` is the i-th *column* —
        reference ``from_data`` (dense.rs:21-29)."""
        return Dense(jnp.asarray(np.asarray(cols).T))

    # ------------------------------------------------------------------ #
    @property
    def dims(self) -> MatDim:
        r, c = self.array.shape
        return MatDim(r, c)

    get_dims = dims.fget

    def get_col(self, col_index: int) -> jax.Array:
        """Reference ``get_col`` (dense.rs:31-33)."""
        return self.array[:, col_index]

    def set_col(self, col_index: int, values) -> "Dense":
        """Functional stand-in for ``get_col_mut`` (dense.rs:35-37): returns
        a new Dense with the column replaced."""
        return Dense(self.array.at[:, col_index].set(jnp.asarray(values)))

    def __eq__(self, other) -> bool:
        if isinstance(other, Dense):
            other = other.array
        return bool(
            np.array_equal(np.asarray(self.array), np.asarray(other))
        )

    def allclose(self, other, rtol=1e-5, atol=1e-6) -> bool:
        if isinstance(other, Dense):
            other = other.array
        return bool(
            np.allclose(np.asarray(self.array), np.asarray(other),
                        rtol=rtol, atol=atol)
        )

    def __repr__(self) -> str:
        return f"Dense({self.dims})\n{np.asarray(self.array)}"

    def __str__(self) -> str:  # display parity (dense.rs:49-62)
        return "\n".join(
            "|" + "".join(f"{v:>5}" for v in row) + "|"
            for row in np.asarray(self.array)
        )


# Static-shape twin: jit specialisation covers it (dense_static.rs:5-53).
DenseS = Dense
