import jax
import jax.numpy as jnp
import numpy as np

from mgroms_jax import NHModel, SolverConfig
from mgroms_jax.bc import extend_h1
from mgroms_jax.cases.seamount import initial_velocities, setup_seamount
from mgroms_jax.ops.relax import tridiag
from mgroms_jax.ops.stencil import apply_op


def test_tridiag_matches_dense():
    rng = np.random.default_rng(0)
    nz, ny, nx = 7, 3, 2
    d = rng.uniform(2.0, 3.0, (nz, ny, nx))
    dd = rng.uniform(-1.0, -0.5, (nz - 1, ny, nx))
    b = rng.standard_normal((nz, ny, nx))
    x = np.asarray(tridiag(jnp.asarray(d), jnp.asarray(dd), jnp.asarray(b)))
    for j in range(ny):
        for i in range(nx):
            A = (np.diag(d[:, j, i]) + np.diag(dd[:, j, i], 1)
                 + np.diag(dd[:, j, i], -1))
            np.testing.assert_allclose(x[:, j, i],
                                       np.linalg.solve(A, b[:, j, i]),
                                       rtol=1e-10)


def test_tridiag_pcr_matches_thomas():
    from mgroms_jax.ops.relax import tridiag_pcr
    rng = np.random.default_rng(3)
    for nz in (1, 2, 5, 8, 64):
        d = rng.uniform(2.0, 3.0, (nz, 4, 3))
        dd = rng.uniform(-1.0, -0.5, (max(nz - 1, 0), 4, 3))
        b = rng.standard_normal((nz, 4, 3))
        x1 = np.asarray(tridiag(jnp.asarray(d), jnp.asarray(dd),
                                jnp.asarray(b)))
        x2 = np.asarray(tridiag_pcr(jnp.asarray(d), jnp.asarray(dd),
                                    jnp.asarray(b)))
        np.testing.assert_allclose(x2, x1, rtol=1e-10, atol=1e-12)


def test_direct_coarsest_converges():
    """cfg.coarsest='direct' (exact dense coarse solve) converges at least
    as fast as the reference's ns_coarsest relaxation sweeps."""
    m = _model(16, 16, 16, coarsest="direct")
    u, v, w = initial_velocities(16, 16, 16)
    b = m.rhs(u, v, w)
    p, info = m.pressure_solve(b, tol=1e-10, maxiter=20)
    m2 = _model(16, 16, 16)
    p2, info2 = m2.pressure_solve(b, tol=1e-10, maxiter=20)
    assert info.res <= 1e-10
    assert info.niter <= info2.niter
    np.testing.assert_allclose(np.asarray(p), np.asarray(p2),
                               atol=1e-7 * np.abs(np.asarray(p2)).max())


def test_pcr_solver_converges():
    m = _model(16, 16, 16, tridiag="pcr")
    u, v, w = initial_velocities(16, 16, 16)
    b = m.rhs(u, v, w)
    p, info = m.pressure_solve(b, tol=1e-10, maxiter=20)
    assert info.res <= 1e-10


def _model(nx, ny, nz, **cfg_kw):
    m = NHModel(nx, ny, nz, cfg=SolverConfig(**cfg_kw))
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


def test_mg_matches_direct_solve():
    """Multigrid solution equals a dense direct solve of the same operator
    (the reference's MATLAB prototypes do this check — solve_pressure_ND.m)."""
    nx = ny = nz = 8
    m = _model(nx, ny, nz)
    u, v, w = initial_velocities(nx, ny, nz)
    b = m.rhs(u, v, w)
    p, info = m.pressure_solve(b, tol=1e-13, maxiter=40)
    # dense operator
    n = nz * ny * nx
    eye = jnp.eye(n).reshape(n, nz, ny, nx)
    cols = jax.vmap(lambda e: apply_op(extend_h1(e), m.ops[0].cA, True))(eye)
    A = np.asarray(cols.reshape(n, n)).T
    pd = np.linalg.solve(A, np.asarray(b).ravel())
    np.testing.assert_allclose(np.asarray(p).ravel(), pd,
                               atol=1e-8 * np.abs(pd).max())


def test_seamount_convergence_and_projection():
    """End-to-end seamount 32^3: F-cycles converge fast and the corrected
    velocity field is non-divergent (driver checks,
    mg_testseamount.f90:185-198)."""
    nx = ny = nz = 32
    m = _model(nx, ny, nz)
    u, v, w = initial_velocities(nx, ny, nz)
    b0 = m.rhs(u, v, w)
    uc, vc, wc, p, info = m.solve(u, v, w, tol=1e-11, maxiter=30)
    assert info.res <= 1e-11
    # healthy multigrid: large mean reduction per F-cycle
    hist = np.array(info.history)
    mean_conv = (hist[-1] / hist[0]) ** (1.0 / info.niter)
    assert mean_conv < 0.3, f"convergence factor too weak: {mean_conv}"
    # non-divergence of the corrected field.  Away from the lateral
    # boundary this is machine zero; on the boundary ring the BC-in-halo
    # discretization leaves an O(0.1%) remnant (div(G p) != A p only where
    # the mirror halo folds slope couplings through a wall) — a property of
    # the reference discretization as well (its check prints the field for
    # human inspection with no assertion, mg_testseamount.f90:196-198).
    div = np.abs(np.asarray(m.rhs(uc, vc, wc)))
    div0 = float(jnp.max(jnp.abs(b0)))
    assert div[:, 2:-2, 2:-2].max() < 1e-9 * div0
    assert div.max() < 1e-2 * div0


def test_device_loop_matches_host_loop():
    """solver._solve_device_loop (whole convergence loop as one
    lax.while_loop program, one host sync per solve) must reproduce the
    host loop's iterate count, history and pressure exactly — same
    cycle_step body, so f64 histories are bitwise up to XLA scheduling."""
    from mgroms_jax.solver import solve_p
    nx = ny = nz = 16
    m = _model(nx, ny, nz)
    u, v, w = initial_velocities(nx, ny, nz)
    b = m.rhs(u, v, w)
    p0, i0 = solve_p(m.backend, b, m.cfg, tol=1e-10, maxiter=20,
                     device_loop=False)
    p1, i1 = solve_p(m.backend, b, m.cfg, tol=1e-10, maxiter=20,
                     device_loop=True)
    assert i1.niter == i0.niter
    assert len(i1.history) == len(i0.history)
    # atol floor: residuals at the 1e-11 floor differ by ~1 ulp of the
    # O(1) summands (the two loop forms compile the same cycle_step in
    # different program contexts; XLA fusion choices differ)
    np.testing.assert_allclose(np.array(i1.history), np.array(i0.history),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p0),
                               rtol=1e-12, atol=1e-14)


def test_relax_reduces_residual():
    nx = ny = nz = 16
    m = _model(nx, ny, nz)
    u, v, w = initial_velocities(nx, ny, nz)
    b = m.rhs(u, v, w)
    be = m.backend
    p = be.zeros(0)
    r0 = float(jnp.linalg.norm(be.residual(0, p, b)))
    p = be.relax(0, p, b, 4)
    r1 = float(jnp.linalg.norm(be.residual(0, p, b)))
    assert r1 < 0.7 * r0


def test_four_color_and_gs_converge():
    """FC and GS converge to tolerance AND at a healthy per-cycle factor.

    Documented deviation (PARITY.md): the reference's GS is a sequential
    in-place sweep; ours is a simultaneous column-Jacobi, so GS residual
    HISTORIES cannot match the reference's — this test pins that the
    deviation still smooths effectively (measured mean reduction on this
    case: ~2.7x/F-cycle for column-Jacobi GS, >>10x for FC)."""
    nx = ny = nz = 16
    for method, min_factor in (("FC", 10.0), ("GS", 2.0)):
        m = _model(nx, ny, nz, relax_method=method)
        u, v, w = initial_velocities(nx, ny, nz)
        b = m.rhs(u, v, w)
        p, info = m.pressure_solve(b, tol=1e-9, maxiter=30)
        assert info.res <= 1e-9, f"{method} failed: {info.history}"
        hist = np.array(info.history)
        mean_conv = (hist[0] / hist[-1]) ** (1.0 / info.niter)
        assert mean_conv >= min_factor, (
            f"{method} convergence factor too weak: {mean_conv}")


def test_nearest_interp_converges():
    m = _model(16, 16, 16, interp_type="nearest", restrict_type="avg")
    u, v, w = initial_velocities(16, 16, 16)
    b = m.rhs(u, v, w)
    p, info = m.pressure_solve(b, tol=1e-9, maxiter=40)
    assert info.res <= 1e-9


def test_device_loop_cycles_per_check_not_dividing_maxiter():
    """cycles_per_check that does not divide maxiter: the device loop's
    final history write lands past maxiter — the history buffer must be
    sized for it (an out-of-bounds .at[].set is silently dropped by XLA,
    which used to leave the device loop reporting a stale final
    residual)."""
    from mgroms_jax.solver import solve_p
    nx = ny = nz = 16
    m = _model(nx, ny, nz, cycles_per_check=2)
    u, v, w = initial_velocities(nx, ny, nz)
    b = m.rhs(u, v, w)
    p0, i0 = solve_p(m.backend, b, m.cfg, tol=1e-10, maxiter=5,
                     device_loop=False)
    p1, i1 = solve_p(m.backend, b, m.cfg, tol=1e-10, maxiter=5,
                     device_loop=True)
    assert i1.niter == i0.niter
    assert len(i1.history) == len(i0.history)
    np.testing.assert_allclose(np.array(i1.history), np.array(i0.history),
                               rtol=1e-12, atol=1e-15)
    assert i1.res == i1.history[-1]


def test_device_loop_zero_rhs_degenerates_like_host():
    """b == 0 makes every residual norm 0/0 = NaN; both loop forms must
    return the same degenerate (nan,) history instead of crashing."""
    from mgroms_jax.solver import solve_p
    nx = ny = nz = 16
    m = _model(nx, ny, nz)
    b = jnp.zeros((nz, ny, nx), dtype=m.dtype)
    p0, i0 = solve_p(m.backend, b, m.cfg, tol=1e-10, maxiter=4,
                     device_loop=False)
    p1, i1 = solve_p(m.backend, b, m.cfg, tol=1e-10, maxiter=4,
                     device_loop=True)
    assert i0.niter == 0 and i1.niter == 0
    assert np.isnan(i0.history).all() and np.isnan(i1.history).all()
    assert np.asarray(p1).max() == 0.0
