"""Steady-state device timing.

JAX dispatches asynchronously, so a wall-clock around a call measures the
enqueue unless it ends in ``jax.block_until_ready``.  The timer compiles
and runs the step once (warm-up, outside the window), then times ``iters``
back-to-back calls that feed each other through the carry, and blocks on
the last result before reading the clock.
"""

from __future__ import annotations

import time
from typing import Callable

import jax


def time_device_fn(step: Callable, carry, iters: int = 20,
                   warmup: bool = True, args: tuple = (),
                   jit: bool = True) -> float:
    """Seconds per application of ``step(carry, *args) -> carry``.  ``step``
    must be jit-compatible and its output pytree structure must match
    ``carry``; ``args`` (operators, right-hand sides) are passed as traced
    arguments on every call, never baked in as constants.  ``jit=False``
    times an already-jitted ``step`` as it is (its compiled program is
    reused, not wrapped in a new one)."""
    f = jax.jit(step) if jit else step
    if warmup:
        carry = jax.block_until_ready(f(carry, *args))
    t0 = time.perf_counter()
    for _ in range(iters):
        carry = f(carry, *args)
    jax.block_until_ready(carry)
    return (time.perf_counter() - t0) / iters
