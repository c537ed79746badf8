import os

import jax.numpy as jnp
import numpy as np

from mgroms_jax import NHModel, SolverConfig
from mgroms_jax.cases.seamount import initial_velocities, setup_seamount


def _model(nx=16, ny=16, nz=16, **kw):
    m = NHModel(nx, ny, nz, cfg=SolverConfig(**kw))
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


def test_galerkin_ratio():
    """<p, A_c p> vs <P p, A_f P p> ratio ~ 4 (testgalerkin,
    mg_solvers.f90:203-288, expectation stated at :281-286)."""
    from mgroms_jax.solver import testgalerkin
    m = _model(32, 32, 32)
    _, _, ratio = testgalerkin(m.backend, 1, m.cfg)
    # smooth field: both norms approximate the same energy integral
    assert 3.0 < ratio < 5.0, ratio
    # rough random field: interpolation damps energy, ratio inflates but
    # stays O(10) (reference's live code path uses random data)
    _, _, ratio_r = testgalerkin(m.backend, 1, m.cfg, field="random")
    assert 4.0 < ratio_r < 30.0, ratio_r


def test_vcycle2_reduces_residual():
    """Partial-depth V-cycle (Vcycle2, mg_solvers.f90:155-177) smooths."""
    from mgroms_jax.solver import vcycle2
    m = _model()
    be = m.backend
    u, v, w = initial_velocities(16, 16, 16)
    b = m.rhs(u, v, w)
    L = be.nlevs
    ps = [be.zeros(l) for l in range(L)]
    bs = [b] + [None] * (L - 1)
    r0 = float(jnp.linalg.norm(be.residual(0, ps[0], b)))
    ps = vcycle2(be, ps, bs, top=0, bottom=1, cfg=m.cfg)
    r1 = float(jnp.linalg.norm(be.residual(0, ps[0], b)))
    assert r1 < 0.1 * r0


def test_analytic_rhs_solve():
    """Solver-only path with the dipole RHS (rhs_seamount,
    mg_define_rhs.f90:12-63)."""
    from mgroms_jax.cases.analytic_rhs import (random_patches, rhs_random,
                                               rhs_seamount)
    m = _model()
    b = rhs_seamount(16, 16, 16)
    p, info = m.pressure_solve(b, tol=1e-9, maxiter=25)
    assert info.res <= 1e-9
    assert rhs_random(4, 4, 4).shape == (4, 4, 4)
    assert random_patches(4, 4, 4, npatches=5).shape == (4, 4, 4)


def test_cuc_synthetic_case():
    """Small-scale CUC-style run: strongly stretched s-coordinates
    (theta=6, hc=250) over a continental slope."""
    from mgroms_jax.cases.cuc import setup_cuc_synthetic
    c = setup_cuc_synthetic(32, 32, 16)
    m = NHModel(32, 32, 16)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    u, v, w = initial_velocities(32, 32, 16)
    b = m.rhs(u, v, w)
    p, info = m.pressure_solve(b, tol=1e-8, maxiter=40)
    assert info.res <= 1e-8, info.history


def test_cuc_file_roundtrip(tmp_path):
    """load_cuc reads a netCDF grid file with the reference transforms
    (dx = 1/pm floored at 1 m, mg_setup_tests.f90:68-101)."""
    from scipy.io import netcdf_file
    from mgroms_jax.cases.cuc import load_cuc
    ny = nx = 8
    path = str(tmp_path / "cuc_nhgrd.nc")
    with netcdf_file(path, "w") as f:
        f.createDimension("y", ny + 2)
        f.createDimension("x", nx + 2)
        h = f.createVariable("h", "d", ("y", "x"))
        pm = f.createVariable("pm", "d", ("y", "x"))
        pn = f.createVariable("pn", "d", ("y", "x"))
        h[:] = 1000.0
        pm[:] = 1.0 / 200.0
        pn[:] = 1e3          # pathological: dy = 1/pn = 1e-3 -> floored to 1
    case = load_cuc(path, nx, ny)
    assert case.dx.shape == (ny, nx)
    assert float(case.dx[0, 0]) == 200.0
    assert float(case.dy[0, 0]) == 1.0
    assert case.hc == 250.0


def test_netcdf_output_stage_dumps(tmp_path):
    """cfg.netcdf_output=True produces the reference's stage dumps
    (nhydro.f90:85-95,130-132; mg_define_matrix.f90:187-194,668-673;
    mg_solvers.f90:74-77)."""
    from mgroms_jax.io.diagnostics import read_field
    m = _model(8, 8, 8, netcdf_output=True, output_dir=str(tmp_path))
    # assembly-stage dumps: metrics + one cA per level
    for stem in ("dx", "dy", "zr", "zw"):
        assert (tmp_path / f"{stem}_{stem}_0000_0001.nc").exists()
    nlevs = len(m.levels)
    for lev in range(1, nlevs + 1):
        assert (tmp_path / f"cA_ca_0000_{lev:04d}.nc").exists()
    u, v, w = initial_velocities(8, 8, 8)
    uc, vc, wc, p, info = m.solve(u, v, w, tol=1e-8, maxiter=10)
    assert (tmp_path / "b_b_0000_0001.nc").exists()       # RHS dump
    assert (tmp_path / "p_end_p_0000.nc").exists()        # end-of-solve
    assert (tmp_path / "r_end_r_0000.nc").exists()
    assert (tmp_path / "p_p_0000_0001.nc").exists()       # per-iteration
    div = m.check_nondivergence(uc, vc, wc)               # check.nc dump
    assert (tmp_path / "check_b_0000_0001.nc").exists()
    # dumped pressure round-trips and matches the returned solution
    pd = read_field(str(tmp_path / "p_end_p_0000.nc"), "p")
    np.testing.assert_allclose(pd, np.asarray(p))
    # interior nondivergence is machine zero; the boundary ring keeps the
    # documented O(1%) BC-in-halo remnant (see test_solver.py notes)
    divf = np.abs(read_field(str(tmp_path / "check_b_0000_0001.nc"), "b"))
    b0 = float(jnp.max(jnp.abs(m.rhs(u, v, w))))
    assert divf[:, 2:-2, 2:-2].max() < 1e-7 * b0
    assert float(div) < 5e-2 * b0


def _isolate_driver(monkeypatch, tmp_path):
    """Run a driver in ``tmp_path`` (restored afterwards) with its compile
    cache left to JAX (a set JAX_COMPILATION_CACHE_DIR makes the driver's
    cache helper set no directory of its own)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))


def test_driver_smoke(tmp_path, capsys, monkeypatch):
    """The seamount driver runs end-to-end (reference testseamount
    program)."""
    from mgroms_jax.drivers.seamount import main
    hist = str(tmp_path / "hist.txt")
    _isolate_driver(monkeypatch, tmp_path)
    main(["--nx", "8", "--ny", "8", "--nz", "8", "--cpu",
          "--tol", "1e-8", "--maxiter", "20", "--history", hist])
    out = capsys.readouterr().out
    assert "rescaled performance" in out
    assert "max |div| after correction" in out
    lines = open(hist).read().strip().splitlines()
    assert float(lines[-1].split()[0]) <= 1e-8


def test_profile_fcycle_populates_per_level_table():
    """The per-(level, section) profile table carries every level's hot
    sections after one instrumented F-cycle — the reference's per-level
    accounting (tic/toc inside Fcycle/Vcycle/relax, printed by
    print_tictoc, mg_tictoc.f90:114-153)."""
    from mgroms_jax.utils.tictoc import TicToc, profile_fcycle

    m = _model(16, 16, 16)
    u, v, w = initial_velocities(16, 16, 16)
    b = m.rhs(u, v, w)
    tt = profile_fcycle(m.backend, b, m.cfg, device_timer=False,
                        tictoc=TicToc())

    levs = sorted({k[0] for k in tt.table})
    assert len(levs) == m.backend.nlevs       # every level appears
    # level 0 brackets the cycle's own sections
    for sec in ("relax", "prolong"):
        t, c = tt.table[(0, sec)]
        assert c >= 1 and t > 0.0
    # some level restricts (fused or not) and the coarsest relaxes
    assert any(k[1] in ("restrict", "residual_restrict") for k in tt.table)
    t, c = tt.table[(m.backend.nlevs - 1, "relax")]
    assert c >= 1 and t > 0.0
    # the report renders one row per level
    rep = tt.report()
    assert len(rep.strip().splitlines()) == 1 + len(levs)


def test_driver_profile_flag(tmp_path, capsys, monkeypatch):
    """--profile prints the reference-style multi-level table after the
    solve (drivers/common.py)."""
    from mgroms_jax.drivers.seamount import main
    _isolate_driver(monkeypatch, tmp_path)
    main(["--nx", "16", "--ny", "16", "--nz", "16", "--cpu",
          "--tol", "1e-4", "--maxiter", "5", "--profile"])
    out = capsys.readouterr().out
    assert "relax" in out
    # at least 3 levels of rows in the printed table
    table_lines = [l for l in out.splitlines()
                   if l.strip()[:1].isdigit() and "s/" in l]
    assert len(table_lines) >= 3
