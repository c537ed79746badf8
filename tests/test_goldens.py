"""Golden convergence histories.

The reference archives no numbers; its acceptance criterion is the printed
per-iteration residual + convergence factor (fort.100, mg_solvers.f90:59-72).
These goldens freeze our float64 histories so any change to assembly,
transfers, smoothing or BCs that shifts the iterates is caught.
"""

import json
import os

import numpy as np

from mgroms_jax import NHModel, SolverConfig
from mgroms_jax.cases.seamount import initial_velocities, setup_seamount

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def test_seamount32_history_matches_golden():
    with open(os.path.join(GOLDEN_DIR, "seamount32_history.json")) as f:
        gold = json.load(f)
    nx, ny, nz = gold["grid"]
    m = NHModel(nx, ny, nz, cfg=SolverConfig())
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    u, v, w = initial_velocities(nx, ny, nz)
    b = m.rhs(u, v, w)
    p, info = m.pressure_solve(b, tol=1e-12, maxiter=30)
    assert info.niter == gold["niter"]
    # atol floor: normalized residuals below ~1e-15 of ||b|| are summation-
    # order noise (compact relax reorders sums)
    np.testing.assert_allclose(np.array(info.history),
                               np.array(gold["history"]),
                               rtol=1e-6, atol=1e-15)


def test_seamount64_golden_exists_and_is_fast():
    """The 64^3 golden is the flagship record: <= 6 F-cycles to 1e-12 and
    4 cycles to 1e-9 (BASELINE.md north star)."""
    with open(os.path.join(GOLDEN_DIR, "seamount64_history.json")) as f:
        gold = json.load(f)
    hist = gold["history"]
    assert gold["final_res"] <= 1e-12
    assert gold["niter"] <= 6
    cycles_to_1e9 = next(i for i, r in enumerate(hist) if r <= 1e-9)
    assert cycles_to_1e9 <= 5
