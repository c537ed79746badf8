"""Order-exact sequential Gauss-Seidel (ops/relax.relax_gs_exact).

The strongest pin is a direct numpy transliteration of the reference's
loops — relax_3D_8_GS (mg_relax.f90:116-148: i-outer/j-inner in-place
column updates, halo refresh once per sweep), relax_3D_8_heart (:237-305:
the k=1 / interior / k=nz gather branches incl. the cmatrix='real' bottom
couplings) and tridiag (:308-334) — written here from the Fortran text,
independently of the library's vectorized term tables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgroms_jax.bc import extend_h1
from mgroms_jax.ops.relax import relax_gs_exact


def _np_gs_sweep(p, b, cA, real):
    """One reference GS sweep in numpy (Fortran indices: A(n,k,j,i) with
    k 1-based, j/i extended 0..n+1; python k == Fortran k-1)."""
    nz, ny, nx = b.shape
    pe = np.array(extend_h1(jnp.asarray(p)))        # fill_halo of prev sweep
    A = lambda n, k, j, i: cA[n - 1, k - 1, j, i]
    B = lambda k, j, i: b[k - 1, j - 1, i - 1]

    for i in range(1, nx + 1):
        for j in range(1, ny + 1):
            P = lambda k, jj, ii: pe[k - 1, jj, ii]
            rhs = np.empty(nz)
            d = np.empty(nz)
            ud = np.zeros(max(nz - 1, 1))
            k = 1
            r = (B(k, j, i)
                 - A(3, k, j, i) * P(k + 1, j - 1, i)
                 - A(4, k, j, i) * P(k, j - 1, i)
                 - A(4, k, j + 1, i) * P(k, j + 1, i)
                 - A(5, k + 1, j + 1, i) * P(k + 1, j + 1, i)
                 - A(6, k, j, i) * P(k + 1, j, i - 1)
                 - A(7, k, j, i) * P(k, j, i - 1)
                 - A(7, k, j, i + 1) * P(k, j, i + 1)
                 - A(8, k + 1, j, i + 1) * P(k + 1, j, i + 1))
            if real:
                r -= (A(5, k, j, i) * P(k, j + 1, i - 1)
                      + A(5, k, j - 1, i + 1) * P(k, j - 1, i + 1)
                      + A(8, k, j, i) * P(k, j - 1, i - 1)
                      + A(8, k, j + 1, i + 1) * P(k, j + 1, i + 1))
            rhs[0] = r
            d[0] = A(1, k, j, i)
            ud[0] = A(2, k + 1, j, i)
            for k in range(2, nz):
                rhs[k - 1] = (
                    B(k, j, i)
                    - A(3, k, j, i) * P(k + 1, j - 1, i)
                    - A(3, k - 1, j + 1, i) * P(k - 1, j + 1, i)
                    - A(4, k, j, i) * P(k, j - 1, i)
                    - A(4, k, j + 1, i) * P(k, j + 1, i)
                    - A(5, k, j, i) * P(k - 1, j - 1, i)
                    - A(5, k + 1, j + 1, i) * P(k + 1, j + 1, i)
                    - A(6, k, j, i) * P(k + 1, j, i - 1)
                    - A(6, k - 1, j, i + 1) * P(k - 1, j, i + 1)
                    - A(7, k, j, i) * P(k, j, i - 1)
                    - A(7, k, j, i + 1) * P(k, j, i + 1)
                    - A(8, k, j, i) * P(k - 1, j, i - 1)
                    - A(8, k + 1, j, i + 1) * P(k + 1, j, i + 1))
                d[k - 1] = A(1, k, j, i)
                ud[k - 1] = A(2, k + 1, j, i)
            k = nz
            rhs[nz - 1] = (
                B(k, j, i)
                - A(3, k - 1, j + 1, i) * P(k - 1, j + 1, i)
                - A(4, k, j, i) * P(k, j - 1, i)
                - A(4, k, j + 1, i) * P(k, j + 1, i)
                - A(5, k, j, i) * P(k - 1, j - 1, i)
                - A(6, k - 1, j, i + 1) * P(k - 1, j, i + 1)
                - A(7, k, j, i) * P(k, j, i - 1)
                - A(7, k, j, i + 1) * P(k, j, i + 1)
                - A(8, k, j, i) * P(k - 1, j, i - 1))
            d[nz - 1] = A(1, k, j, i)
            # tridiag (mg_relax.f90:308-334)
            xc = np.empty(nz)
            gam = np.empty(nz)
            bet = 1.0 / d[0]
            xc[0] = rhs[0] * bet
            for k in range(2, nz + 1):
                gam[k - 1] = ud[k - 2] * bet
                bet = 1.0 / (d[k - 1] - ud[k - 2] * gam[k - 1])
                xc[k - 1] = (rhs[k - 1] - ud[k - 2] * xc[k - 2]) * bet
            for k in range(nz - 1, 0, -1):
                xc[k - 1] = xc[k - 1] - gam[k] * xc[k]
            pe[:, j, i] = xc
    return pe[:, 1:-1, 1:-1]


def _problem(nz, ny, nx, seed=0):
    k = jax.random.PRNGKey(seed)
    ks = jax.random.split(k, 3)
    cA = jax.random.uniform(ks[0], (8, nz, ny + 2, nx + 2), jnp.float64,
                            -0.1, 0.1)
    cA = cA.at[0].add(-4.0)
    p = jax.random.normal(ks[1], (nz, ny, nx), jnp.float64)
    b = jax.random.normal(ks[2], (nz, ny, nx), jnp.float64)
    return cA, p, b


@pytest.mark.parametrize("real_matrix", [True, False])
@pytest.mark.parametrize("nsweeps", [1, 2])
def test_gs_exact_matches_fortran_transliteration(real_matrix, nsweeps):
    nz, ny, nx = 5, 6, 7
    cA, p, b = _problem(nz, ny, nx)
    out = relax_gs_exact(p, b, cA, nsweeps, real_matrix, extend_h1)
    ref = np.asarray(p)
    for _ in range(nsweeps):
        ref = _np_gs_sweep(ref, np.asarray(b), np.asarray(cA), real_matrix)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-13, atol=1e-14)


def test_gs_exact_solver_history_differs_and_converges():
    """End-to-end: cfg(relax_method='GS', gs_exact=True) converges with a
    healthy factor and produces a DIFFERENT history from the simultaneous
    column-Jacobi GS (the documented deviation this mode closes)."""
    from mgroms_jax import NHModel, SolverConfig
    from mgroms_jax.cases.seamount import initial_velocities, setup_seamount

    def run(**kw):
        m = NHModel(16, 16, 8, cfg=SolverConfig(relax_method="GS", **kw))
        c = setup_seamount(16, 16, 8)
        m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                       theta_b=c.theta_b, theta_s=c.theta_s)
        u, v, w = initial_velocities(16, 16, 8)
        return m.solve(u, v, w, tol=1e-9, maxiter=25)

    _, _, _, _, info_x = run(gs_exact=True)
    _, _, _, _, info_j = run()
    assert info_x.res <= 1e-9
    # sequential GS smooths at least as well as the simultaneous sweep
    assert info_x.niter <= info_j.niter
    assert tuple(info_x.history) != tuple(info_j.history)
