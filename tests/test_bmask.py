"""End-to-end land/sea masking (``bmask``, mg_namelist.f90:35).

The reference folds the mask into the matrix coefficients
(mg_define_matrix.f90:375-389,417-433,497-509) and the RHS/projection metric
terms; no shipped driver exercises it, so these are the missing acceptance
tests: a masked solve must converge, leave land cells untouched by the
dynamics, and still produce divergence-free water velocities.
"""

import jax.numpy as jnp
import numpy as np

from mgroms_jax import NHModel, SolverConfig
from mgroms_jax.cases.seamount import initial_velocities, setup_seamount
from mgroms_jax.ops.stencil import apply_op
from mgroms_jax.bc import extend_h1, extend_rmask


def _masked_model(nx=16, ny=16, nz=16):
    """Seamount geometry with a land strip (western two columns) and a
    small island."""
    m = NHModel(nx, ny, nz, cfg=SolverConfig(bmask=True))
    c = setup_seamount(nx, ny, nz)
    rmask = np.ones((ny, nx))
    rmask[:, :2] = 0.0                      # west land strip
    rmask[ny // 2: ny // 2 + 2, nx // 2: nx // 2 + 2] = 0.0   # island
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, rmask=jnp.asarray(rmask),
                   hc=c.hc, theta_b=c.theta_b, theta_s=c.theta_s)
    return m, jnp.asarray(rmask)


def test_bmask_operator_decouples_land():
    """With bmask, the assembled operator has no coupling between water
    and land columns: A p is unchanged on water when land values change."""
    m, rmask = _masked_model()
    cA = m.backend.ops[0].cA
    rng = np.random.default_rng(0)
    shp = (m.nz, m.ny, m.nx)
    p = jnp.asarray(rng.standard_normal(shp))
    land3 = (1.0 - rmask)[None, :, :]
    p_perturbed = p + 7.5 * land3 * jnp.asarray(rng.standard_normal(shp))
    Ap1 = np.asarray(apply_op(extend_h1(p), cA, True))
    Ap2 = np.asarray(apply_op(extend_h1(p_perturbed), cA, True))
    water3 = np.broadcast_to(np.asarray(rmask)[None], shp) > 0.5
    np.testing.assert_allclose(Ap1[water3], Ap2[water3], rtol=0, atol=1e-11)


def test_bmask_solve_converges_and_projects():
    m, rmask = _masked_model()
    u, v, w = initial_velocities(m.nx, m.ny, m.nz)
    uc, vc, wc, p, info = m.solve(u, v, w, tol=1e-9, maxiter=30)
    assert info.res <= 1e-9, info

    # nondivergence on water cells (the reference's check,
    # nhydro.f90:105-134), interior ring excluded as documented
    div = np.asarray(m.rhs(uc, vc, wc))
    b0 = np.asarray(m.rhs(u, v, w))
    water = np.asarray(rmask) > 0.5
    # 2 cells from walls + off the land strip/island ring
    interior = np.zeros_like(water)
    interior[3:-3, 3:-3] = True
    from scipy.ndimage import binary_erosion
    wat_int = binary_erosion(water, iterations=2) & interior
    scale = np.abs(b0).max()
    assert np.abs(div[:, wat_int]).max() <= 1e-8 * scale


def test_bmask_rhs_land_sees_no_horizontal_flux():
    """The mask zeroes the horizontal fluxes (umask/vmask factors,
    mg_compute_rhs.f90:57-71,122-128) but NOT the vertical w-divergence —
    so the RHS on interior land columns must be independent of u and v."""
    m, rmask = _masked_model()
    u, v, w = initial_velocities(m.nx, m.ny, m.nz)
    b1 = np.asarray(m.rhs(u, v, w))
    rng = np.random.default_rng(1)
    u2 = u + jnp.asarray(rng.standard_normal(u.shape))
    v2 = v + jnp.asarray(rng.standard_normal(v.shape))
    b2 = np.asarray(m.rhs(u2, v2, w))
    land = np.asarray(rmask) < 0.5
    from scipy.ndimage import binary_erosion
    land_int = binary_erosion(land)     # off the land/water interface ring
    if land_int.any():
        np.testing.assert_allclose(b1[:, land_int], b2[:, land_int],
                                   rtol=0, atol=1e-9)


def test_extend_rmask_bmask_ring():
    r = jnp.ones((4, 4))
    re = extend_rmask(r, bmask=True)
    assert np.asarray(re[0]).max() == 0.0
    assert np.asarray(re[-1]).max() == 0.0
    assert np.asarray(re[:, 0]).max() == 0.0
    assert np.asarray(re[:, -1]).max() == 0.0
    np.testing.assert_array_equal(np.asarray(re[1:-1, 1:-1]), np.ones((4, 4)))
