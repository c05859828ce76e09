"""Device timing by two-point differencing.

* iterate **on device** inside one jitted ``fori_loop`` whose carry is the
  previous iteration's *normalised output* — full-rank, full-magnitude
  feedback that XLA cannot strength-reduce or pipeline across iterations;
* fence completion with ``jax.block_until_ready``;
* measure at **two iteration counts** and difference, cancelling the fixed
  per-execution cost (dispatch, launch) exactly.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable


def make_loop(step_fn: Callable, normalize: bool = True):
    """Wrap ``step_fn(operand, carry) -> carry`` into a jitted two-point
    measurable loop ``loop(operand, init, inner)``."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnums=(2,))
    def loop(operand, init, inner):
        def body(_, carry):
            out = step_fn(operand, carry)
            if normalize:
                out = out * (
                    1.0 / jnp.maximum(jnp.max(jnp.abs(out)), 1e-30)
                )
            return out
        return jax.lax.fori_loop(0, inner, body, init)

    return loop


def measure_loop(loop, operand, init, *, i1: int = 500, i2: int = 4500,
                 reps: int = 2) -> float:
    """Seconds per iteration of ``loop(operand, init, inner)`` via two-point
    differencing. Compiles/warms both variants first."""
    import jax

    jax.block_until_ready(loop(operand, init, i1))
    jax.block_until_ready(loop(operand, init, i2))
    t = {}
    for inner in (i1, i2):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(loop(operand, init, inner))
            best = min(best, time.perf_counter() - t0)
        t[inner] = best
    return max(t[i2] - t[i1], 1e-12) / (i2 - i1)
