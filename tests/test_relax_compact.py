"""Compact quad-parity relax == masked relax, term for term.

The compact smoother (ops/relax_compact.py) must reproduce the masked RB/FC
iterates exactly — same neighbour-gather terms in the same order, evaluated
only on the active color's columns.
"""

import jax.numpy as jnp
import numpy as np

from mgroms_jax import NHModel, SolverConfig
from mgroms_jax.bc import extend_h1
from mgroms_jax.cases.seamount import initial_velocities, setup_seamount
from mgroms_jax.ops.relax import relax
from mgroms_jax.ops.relax_compact import (
    merge_quads, relax_compact, split_quads)


def _op(nx, ny, nz, **cfg_kw):
    m = NHModel(nx, ny, nz, cfg=SolverConfig(compact=False, **cfg_kw))
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


def test_split_merge_roundtrip():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((5, 6, 8)))
    np.testing.assert_array_equal(np.asarray(merge_quads(split_quads(x))),
                                  np.asarray(x))


def _compare(kind, nx=16, ny=12, nz=8, nsweeps=3, lev=0):
    m = _op(nx, ny, nz)
    cA = m.backend.ops[lev].cA
    shp = (m.backend.levels[lev].nzg, m.backend.levels[lev].nyg,
           m.backend.levels[lev].nxg)
    rng = np.random.default_rng(7)
    p0 = jnp.asarray(rng.standard_normal(shp))
    b = jnp.asarray(rng.standard_normal(shp))
    ref = relax(p0, b, cA, nsweeps, kind, True, extend_fn=extend_h1)
    got = relax_compact(p0, b, cA, nsweeps, kind, True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-13, atol=1e-13)


def test_compact_rb_matches_masked():
    _compare("RB")


def test_compact_fc_matches_masked():
    _compare("FC")


def test_compact_rb_single_sweep_unrolled():
    _compare("RB", nsweeps=1)


def test_compact_rb_coarse_level():
    # a coarser level exercises different band structure (k=1 'real' terms
    # at small nz) and the fori_loop path with many sweeps
    _compare("RB", nx=16, ny=16, nz=8, nsweeps=5, lev=1)


def test_compact_in_solver_matches_masked_history():
    """End-to-end: the compact-smoother solve reproduces the masked-smoother
    residual history."""
    nx = ny = nz = 16
    u, v, w = initial_velocities(nx, ny, nz)

    m1 = _op(nx, ny, nz)
    b = m1.rhs(u, v, w)
    p1, i1 = m1.pressure_solve(b, tol=1e-10, maxiter=10)

    m2 = NHModel(nx, ny, nz, cfg=SolverConfig(compact=True))
    c = setup_seamount(nx, ny, nz)
    m2.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                    theta_b=c.theta_b, theta_s=c.theta_s)
    p2, i2 = m2.pressure_solve(b, tol=1e-10, maxiter=10)

    assert i1.niter == i2.niter
    # deep-convergence tail sits at the f64 residual-norm noise floor;
    # histories agree to roundoff (abs diff ~1e-16 on normalized residuals)
    np.testing.assert_allclose(np.asarray(i2.history), np.asarray(i1.history),
                               rtol=1e-4, atol=1e-15)
    np.testing.assert_allclose(np.asarray(p2), np.asarray(p1),
                               rtol=1e-8, atol=1e-12)
