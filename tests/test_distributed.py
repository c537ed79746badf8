"""Distributed-vs-single-device equivalence on a simulated 8-device CPU mesh.

The reference's multi-node test strategy is small MPI runs on one node
(SURVEY.md section 4); ours is the XLA equivalent: an 8-device virtual CPU
mesh, asserting the distributed solve reproduces the single-device iterates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgroms_jax import NHModel, SolverConfig
from mgroms_jax.cases.seamount import initial_velocities, setup_seamount
from mgroms_jax.levels import build_level_plan
from mgroms_jax.parallel import MeshPlan, make_mesh

needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 virtual devices")


def _solve(nx, ny, nz, mesh_shape=None, comm="gspmd", **cfg_kw):
    m = NHModel(nx, ny, nz, cfg=SolverConfig(**cfg_kw))
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    if mesh_shape is not None:
        m.distribute(*mesh_shape, comm=comm)
    u, v, w = initial_velocities(nx, ny, nz)
    b = m.rhs(u, v, w)
    p, info = m.pressure_solve(b, tol=1e-10, maxiter=12)
    return np.asarray(p), info


@needs8
def test_mesh_plan_deshards_coarse_levels_staged():
    """Staged agglomeration (reference: gradual gathers, mg_grids.f90:
    550-575): the bottleneck mesh axis is dropped first; full replication
    only when both axes are dropped."""
    mesh = make_mesh(4, 2)
    levels = build_level_plan(32, 32, 32)
    plan = MeshPlan.create(mesh, levels, nsmall=8)
    # level 0: 32/4=8, 32/2=16 -> sharded on both axes
    s0 = plan.shards[0]
    assert s0.sharded and s0.shard_py and s0.shard_px
    # level 1: 16/4=4 < 8 in x -> px dropped, py (16/2=8) stays
    s1 = plan.shards[1]
    assert s1.sharded and s1.shard_py and not s1.shard_px
    assert (s1.nx, s1.ny) == (16, 8)
    # level 2: 8/2=4 < 8 in y -> fully replicated
    assert not plan.shards[2].sharded
    # monotonic: dropped axes never re-shard
    for s in plan.shards[2:]:
        assert not s.sharded


@needs8
def test_distributed_matches_single_2x2():
    p1, i1 = _solve(16, 16, 16)
    p2, i2 = _solve(16, 16, 16, mesh_shape=(2, 2))
    assert i2.res <= 1e-10
    np.testing.assert_allclose(p2, p1, rtol=1e-9, atol=1e-9 * np.abs(p1).max())
    # same convergence history to fp round-off (distributed reductions
    # reorder sums, so tiny residuals differ in the last digits)
    np.testing.assert_allclose(i1.history, i2.history, rtol=1e-4)


@needs8
def test_distributed_matches_single_4x2():
    p1, i1 = _solve(32, 16, 8, mesh_shape=None)
    p2, i2 = _solve(32, 16, 8, mesh_shape=(4, 2))
    # this shallow grid (nz=8, 3 levels) converges ~4.7x/cycle
    assert i2.res <= 1e-8
    assert abs(i2.res - i1.res) < 1e-12
    np.testing.assert_allclose(p2, p1, rtol=1e-9, atol=1e-9 * np.abs(p1).max())


@needs8
@pytest.mark.parametrize("comm", ["gspmd", "shard_map"])
def test_staged_agglomeration_solve_matches_single(comm):
    """A plan with an intermediate (single-axis) stage still reproduces the
    single-device iterates.  Grid 64x64x16 on a 2x4 mesh stages:
    both-axes -> both-axes -> py-only -> replicated."""
    from mgroms_jax.parallel import MeshPlan, make_mesh
    mesh = make_mesh(2, 4)
    levels = build_level_plan(64, 64, 16)
    plan = MeshPlan.create(mesh, levels, nsmall=8)
    flags = [(s.shard_py, s.shard_px) for s in plan.shards]
    assert flags[0] == (True, True)
    assert flags[2] == (False, True) or flags[2] == (True, False)
    assert not plan.shards[3].sharded
    p1, i1 = _solve(64, 64, 16)
    p2, i2 = _solve(64, 64, 16, mesh_shape=(2, 4), comm=comm)
    assert i1.niter == i2.niter
    np.testing.assert_allclose(p2, p1, rtol=1e-9, atol=1e-9 * np.abs(p1).max())
    np.testing.assert_allclose(i1.history, i2.history, rtol=1e-4, atol=1e-15)


@needs8
def test_shardmap_tiled_kernels_match_single():
    """The Pallas color-update kernel (plain and residual-emitting)
    running INSIDE shard_map local blocks (interpret mode on the CPU mesh,
    the kernel code path the GPU compiles) reproduces the single-device
    solve.  32x32x16 on a 2x2 mesh: levels 0 and 1 are sharded and run the
    kernel on per-shard packs, coarser levels are replicated."""
    m = NHModel(32, 32, 16, cfg=SolverConfig(pallas_interpret=True))
    c = setup_seamount(32, 32, 16)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    m.distribute(2, 2, comm="shard_map")
    be = m.backend
    # the gates this test exists to pin: the sharded levels must actually
    # run the kernel on per-shard packs
    assert be._use_compact_shard(0) and be._use_kernel_shard(0)
    assert be.packs[0] is not None
    assert be.plan.shards[1].sharded and be._use_kernel_shard(1)
    assert be.packs[1] is not None
    u, v, w = initial_velocities(32, 32, 16)
    b = m.rhs(u, v, w)
    p2, i2 = m.pressure_solve(b, tol=1e-10, maxiter=12)
    p1, i1 = _solve(32, 32, 16)
    assert i1.niter == i2.niter
    np.testing.assert_allclose(np.asarray(p2), p1, rtol=1e-9,
                               atol=1e-9 * np.abs(p1).max())
    np.testing.assert_allclose(i1.history, i2.history, rtol=1e-4, atol=1e-15)


def _solve_e2e(nx, ny, nz, mesh_shape=None, comm="gspmd"):
    m = NHModel(nx, ny, nz, cfg=SolverConfig())
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    if mesh_shape is not None:
        m.distribute(*mesh_shape, comm=comm)
    u, v, w = initial_velocities(nx, ny, nz)
    uc, vc, wc, p, info = m.solve(u, v, w, tol=1e-10, maxiter=12)
    div = float(m.check_nondivergence(uc, vc, wc))
    return (np.asarray(uc), np.asarray(vc), np.asarray(wc), np.asarray(p),
            info, div)


@needs8
@pytest.mark.parametrize("comm", ["gspmd", "shard_map"])
def test_full_solve_distributed_end_to_end(comm):
    """The FULL nhydro_solve — rhs + cycles + projection + nondivergence —
    distributed over a 2x4 mesh equals the single-device run (per-shard
    staggered tiles + lbc_null wall masks, parallel/physics.py; reference
    contract: mg_compute_rhs.f90:170-172, mg_correct_uvw.f90)."""
    u1, v1, w1, p1, i1, d1 = _solve_e2e(32, 16, 8)
    u2, v2, w2, p2, i2, d2 = _solve_e2e(32, 16, 8, mesh_shape=(2, 4),
                                        comm=comm)
    # the distributed RHS is ulp-identical (same arithmetic per shard);
    # iterates agree to solver round-off
    assert i1.niter == i2.niter
    np.testing.assert_allclose(p2, p1, rtol=1e-9, atol=1e-9 * np.abs(p1).max())
    for a, b_ in ((u2, u1), (v2, v1), (w2, w1)):
        np.testing.assert_allclose(a, b_, rtol=1e-9,
                                   atol=1e-9 * max(np.abs(b_).max(), 1.0))
    assert abs(d2 - d1) <= 1e-9 * max(d1, 1.0)


@needs8
def test_distributed_rhs_matches_single_exactly():
    """compute_rhs on per-shard tiles is elementwise identical to the
    single-device RHS (same flux arithmetic; seam faces computed twice
    from identical inputs)."""
    nx, ny, nz = 32, 16, 8
    m1 = NHModel(nx, ny, nz, cfg=SolverConfig())
    c = setup_seamount(nx, ny, nz)
    m1.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                    theta_b=c.theta_b, theta_s=c.theta_s)
    u, v, w = initial_velocities(nx, ny, nz)
    # random velocities exercise every flux term incl. the k=1 cross terms
    rng = np.random.default_rng(11)
    u = u + jnp.asarray(rng.standard_normal(u.shape))
    v = v + jnp.asarray(rng.standard_normal(v.shape))
    w = w + jnp.asarray(rng.standard_normal(w.shape))
    b1 = np.asarray(m1.rhs(u, v, w))
    m2 = NHModel(nx, ny, nz, cfg=SolverConfig())
    m2.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                    theta_b=c.theta_b, theta_s=c.theta_s)
    m2.distribute(4, 2, comm="gspmd")
    b2 = np.asarray(m2.rhs(u, v, w))
    np.testing.assert_array_equal(b2, b1)


@needs8
def test_distributed_device_loop_matches_host_loop():
    """solver._solve_device_loop under a MESH backend: the whole
    convergence loop as one on-device while_loop over the distributed
    pytree must reproduce the distributed host loop's history and
    pressure (weak spot flagged in round 4 — the parity was previously
    pinned single-device only)."""
    from mgroms_jax.solver import solve_p
    nx = ny = nz = 16
    m = NHModel(nx, ny, nz, cfg=SolverConfig())
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    m.distribute(2, 2)
    u, v, w = initial_velocities(nx, ny, nz)
    b = m.rhs(u, v, w)
    p0, i0 = solve_p(m.backend, b, m.cfg, tol=1e-10, maxiter=12,
                     device_loop=False)
    p1, i1 = solve_p(m.backend, b, m.cfg, tol=1e-10, maxiter=12,
                     device_loop=True)
    assert i1.niter == i0.niter
    assert len(i1.history) == len(i0.history)
    # under a mesh the while_loop program may schedule the reductions
    # differently from the per-cycle host programs, so tiny residuals
    # agree to roundoff, not bitwise (same contract as the other
    # distributed history comparisons above)
    np.testing.assert_allclose(np.array(i1.history), np.array(i0.history),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p0),
                               rtol=1e-9, atol=1e-9 * np.abs(p0).max())
