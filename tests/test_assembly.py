import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgroms_jax.assembly import build_operators
from mgroms_jax.bc import extend_h1
from mgroms_jax.cases.seamount import setup_seamount
from mgroms_jax.config import SolverConfig
from mgroms_jax.levels import build_level_plan
from mgroms_jax.ops.stencil import apply_op


def _build(nx=8, ny=8, nz=8, cfg=None):
    cfg = cfg or SolverConfig()
    case = setup_seamount(nx, ny, nz)
    levels = build_level_plan(nx, ny, nz)
    ops, metrics = build_operators(levels, case.dx, case.dy, case.zeta,
                                   case.h, jnp.ones((ny, nx)), case.hc,
                                   case.theta_b, case.theta_s, cfg)
    return levels, ops, metrics, cfg


def _dense(cA, real_matrix, nz, ny, nx):
    n = nz * ny * nx
    eye = jnp.eye(n).reshape(n, nz, ny, nx)
    cols = jax.vmap(lambda e: apply_op(extend_h1(e), cA, real_matrix))(eye)
    return np.asarray(cols.reshape(n, n)).T


def test_operator_symmetry_interior():
    """The 15-point operator is symmetric for couplings between points away
    from the lateral boundary (8 stored bands + mirrored reads).  Boundary-
    adjacent entries are *not* exactly symmetric: the homogeneous-Neumann
    mirror halo folds halo couplings back onto interior points — a property
    of the reference discretization too (BCs live in fill_halo; the MATLAB
    prototype solve2D_jm/check.m compares exactly this BC-in-halo variant
    against the symmetric BC-in-matrix one)."""
    levels, ops, _, cfg = _build(6, 6, 4)
    for lev, op in enumerate(ops):
        s = levels[lev]
        nz, ny, nx = s.nzg, s.nyg, s.nxg
        A = _dense(op.cA, True, nz, ny, nx)
        interior = np.zeros((nz, ny, nx), dtype=bool)
        interior[:, 1:-1, 1:-1] = True
        sel = interior.ravel()
        Aii = A[np.ix_(sel, sel)]
        np.testing.assert_allclose(Aii, Aii.T, rtol=0, atol=1e-11,
                                   err_msg=f"level {lev} not symmetric")
        # whole matrix is symmetric to the BC-folding level (< 5 %)
        scale = np.abs(A).max()
        assert np.abs(A - A.T).max() < 0.05 * scale


def test_constant_nullspace_below_surface():
    """A * 1 = 0 away from the surface: the diagonal is the negative row sum
    of exactly the couplings the stencil reads (mg_define_matrix.f90:615-657)
    — a strong consistency check between assembly and stencil application."""
    levels, ops, _, cfg = _build(8, 8, 8)
    for lev, op in enumerate(ops):
        s = levels[lev]
        ones = jnp.ones((s.nzg, s.nyg, s.nxg))
        Ap = np.asarray(apply_op(extend_h1(ones), op.cA, True))
        scale = np.abs(np.asarray(op.cA[0])).max()
        # all rows below the surface annihilate constants
        np.testing.assert_allclose(Ap[:-1], 0.0, atol=1e-10 * scale)
        # surface rows do not (free-surface Dirichlet terms)
        assert np.abs(Ap[-1]).max() > 1e-6 * scale


def test_vertical_band_is_conductance():
    """cA2(k) == cw(k) for interior k without bmask
    (mg_define_matrix.f90:495, :569)."""
    from mgroms_jax.assembly import slope_terms
    from mgroms_jax.bc import extend_h2
    from mgroms_jax.grids import setup_zr_zw_croco

    case = setup_seamount(8, 8, 8)
    cfg = SolverConfig()
    levels = build_level_plan(8, 8, 8)
    ops, _ = build_operators(levels, case.dx, case.dy, case.zeta, case.h,
                             jnp.ones((8, 8)), case.hc, case.theta_b,
                             case.theta_s, cfg)
    zr, zw = setup_zr_zw_croco(case.hc, case.theta_b, case.theta_s,
                               case.zeta, case.h, 8)
    dxe = extend_h1(case.dx)
    dye = extend_h1(case.dy)
    _, _, _, cw = slope_terms(dxe, dye, extend_h2(zr), extend_h2(zw))
    cA2 = np.asarray(ops[0].cA[1])
    np.testing.assert_allclose(cA2[1:, 1:-1, 1:-1],
                               np.asarray(cw)[1:8, 1:-1, 1:-1], rtol=1e-12)


def test_seamount_zr_zw_values():
    """theta = 0, zeta = 0 new_s_coord: analytic reduction
    z = (hc*sc - sc^2*h) * h / (h + hc)."""
    from mgroms_jax.grids import setup_zr_zw_croco
    h = jnp.full((3, 3), 4000.0)
    nz = 4
    zr, zw = setup_zr_zw_croco(4000.0, 0.0, 0.0, jnp.zeros((3, 3)), h, nz)
    k = np.arange(1, nz + 1)
    sc_r = (k - nz - 0.5) / nz
    expect = (4000.0 * sc_r - sc_r ** 2 * 4000.0) * 4000.0 / 8000.0
    np.testing.assert_allclose(np.asarray(zr)[:, 1, 1], expect, rtol=1e-12)
    assert np.allclose(np.asarray(zw)[-1], 0.0)
    # zw strictly increasing in k
    assert (np.diff(np.asarray(zw), axis=0) > 0).all()


def test_namelist_roundtrip(tmp_path):
    from mgroms_jax.config import read_namelist
    f = tmp_path / "nh_namelist"
    f.write_text("""&nhparam
  solver_prec    = 1.d-12,
  solver_maxiter = 30,
  ns_coarsest    = 32,
  cmatrix        = 'real',
  relax_method   = 'RB',
  aggressive     = .false.
/
""")
    cfg = read_namelist(str(f))
    assert cfg.solver_prec == 1e-12
    assert cfg.solver_maxiter == 30
    assert cfg.ns_coarsest == 32
    assert cfg.relax_kind == "RB"
    assert cfg.aggressive is False


def test_linear_linear_forbidden():
    with pytest.raises(ValueError):
        SolverConfig(interp_type="linear", restrict_type="linear")
