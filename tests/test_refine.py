"""Mixed-precision defect correction: f32 cycles, f64 accuracy."""

import jax
import jax.numpy as jnp
import numpy as np

from mgroms_jax import SolverConfig
from mgroms_jax.cases.seamount import initial_velocities, setup_seamount
from mgroms_jax.refine import build_pair, refined_pressure_solve


def test_refined_solve_reaches_f64_accuracy():
    nx = ny = nz = 16
    case = setup_seamount(nx, ny, nz, dtype=jnp.float64)
    m32, m64 = build_pair(nx, ny, nz, case)

    u, v, w = initial_velocities(nx, ny, nz, dtype=jnp.float64)
    b64 = m64.rhs(u, v, w)

    p64, info = refined_pressure_solve(m32, m64, b64, tol=1e-11,
                                       max_rounds=8)
    assert info.res <= 1e-11, info
    # well below the f32 floor (~4e-5): the refinement did its job
    assert info.history[1] < 1e-3          # after one round
    assert info.rounds <= 8

    # the returned pressure really solves the f64 system
    r = m64.backend.residual(0, p64, b64)
    rel = float(jnp.sqrt(jnp.sum(r * r)) / jnp.sqrt(jnp.sum(b64 * b64)))
    assert rel <= 1e-11


def test_refined_beats_pure_f32_floor():
    nx = ny = nz = 16
    case = setup_seamount(nx, ny, nz, dtype=jnp.float64)
    m32, m64 = build_pair(nx, ny, nz, case)
    u, v, w = initial_velocities(nx, ny, nz, dtype=jnp.float64)

    # pure f32 solve floors
    b32 = m32.rhs(jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32),
                  jnp.asarray(w, jnp.float32))
    _, info32 = m32.pressure_solve(b32, tol=1e-12, maxiter=12)

    b64 = m64.rhs(u, v, w)
    _, info = refined_pressure_solve(m32, m64, b64, tol=1e-12,
                                     max_rounds=10)
    assert info.res < max(info32.res, 1e-7) * 1e-2
