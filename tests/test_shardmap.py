"""Explicit shard_map backend vs single-device equivalence (8-dev CPU mesh).

The ppermute halo exchange + per-shard-extended operators must reproduce
the single-device iterates exactly: seam halos carry neighbour interior
values, domain-edge halos the Neumann mirror — the same extended array
bc.extend_h1 builds globally (reference protocol: mg_mpi_exchange.f90).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from mgroms_jax import NHModel, SolverConfig
from mgroms_jax.bc import extend_h1
from mgroms_jax.cases.seamount import initial_velocities, setup_seamount
from mgroms_jax.parallel import make_mesh
from mgroms_jax.parallel.exchange import block_extended, halo_extend

needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 virtual devices")


@needs8
def test_halo_extend_matches_global_extension():
    """Per-shard halo_extend == the shard's slice of the global extend_h1
    (both seam and physical-edge halos)."""
    mesh = make_mesh(4, 2)
    nz, ny, nx = 3, 8, 16
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((nz, ny, nx)))

    f = jax.jit(jax.shard_map(
        halo_extend, mesh=mesh,
        in_specs=(P(None, "py", "px"),),
        out_specs=P(None, "py", "px")))
    got = np.asarray(f(x))          # blocked: (nz, 2*(4+2), 4*(4+2))

    ge = np.asarray(extend_h1(x))   # global (nz, ny+2, nx+2)
    want = np.asarray(block_extended(jnp.asarray(ge), 2, 4))
    np.testing.assert_array_equal(got, want)


def _solve(nx, ny, nz, mesh_shape=None, comm="gspmd", cfg_extra=None,
           **cfg_kw):
    cfg_kw = dict(cfg_kw, **(cfg_extra or {}))
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
def test_shardmap_matches_single_4x2():
    p1, i1 = _solve(32, 16, 8)
    p2, i2 = _solve(32, 16, 8, mesh_shape=(4, 2), comm="shard_map")
    assert i2.res <= 1e-8
    np.testing.assert_allclose(p2, p1, rtol=1e-9,
                               atol=1e-9 * np.abs(p1).max())
    np.testing.assert_allclose(i1.history, i2.history, rtol=1e-4)


@needs8
def test_shardmap_matches_gspmd_2x2():
    p1, i1 = _solve(16, 16, 16, mesh_shape=(2, 2), comm="gspmd")
    p2, i2 = _solve(16, 16, 16, mesh_shape=(2, 2), comm="shard_map")
    assert i2.res <= 1e-10
    np.testing.assert_allclose(p2, p1, rtol=1e-9,
                               atol=1e-9 * np.abs(p1).max())


@needs8
def test_blocked_operator_storage_is_sharded():
    """Per-shard-extended cA: each device holds one extended tile (the
    per-rank allocation of mg_grids.f90:24-65), not a replica."""
    m = NHModel(32, 16, 8, cfg=SolverConfig())
    c = setup_seamount(32, 16, 8)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    m.distribute(4, 2, comm="shard_map")
    cA = m.backend.ops[0].cA
    assert cA.shape[-2:] == (2 * (8 + 2), 4 * (8 + 2))
    # sharded: each addressable shard holds 1/8 of the blocked array
    shard_shapes = {s.data.shape for s in cA.addressable_shards}
    assert shard_shapes == {(8, 8, 10, 10)}


@needs8
def test_shardmap_compact_matches_single():
    """Compact quad-parity smoothing across shard seams (ppermute quad
    exchange) reproduces the single-device compact solve."""
    # local tiles 8x8 (even) on a 4x2 mesh: compact runs on the sharded
    # level 0 (CPU gate accepts any even tile)
    p1, i1 = _solve(32, 16, 8, cfg_extra=dict(compact=True))
    p2, i2 = _solve(32, 16, 8, mesh_shape=(4, 2), comm="shard_map",
                    cfg_extra=dict(compact=True))
    assert i2.res <= 1e-8
    np.testing.assert_allclose(p2, p1, rtol=1e-9,
                               atol=1e-9 * np.abs(p1).max())
    np.testing.assert_allclose(i1.history, i2.history, rtol=1e-4,
                               atol=1e-15)


@needs8
def test_shardmap_quad_persistent_sharded_relax():
    """Sharded levels carry quad-persistent state: relax accepts and
    returns a QuadField (no split/merge inside), per-shard packs persist
    the operator, and the merged result equals the single-device compact
    smoother bit-for-bit."""
    from mgroms_jax.ops.relax_compact import QuadField, relax_compact

    nz, ny, nx = 8, 16, 32
    m = NHModel(nx, ny, nz, cfg=SolverConfig(compact=True))
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    cA_full = m.ops[0].cA
    m.distribute(4, 2, comm="shard_map")
    be = m.backend
    assert be.plan.shards[0].sharded
    assert be.state_quads(0) and be.packs[0] is not None

    rng = np.random.default_rng(7)
    p = jnp.asarray(rng.standard_normal((nz, ny, nx)))
    b = jnp.asarray(rng.standard_normal((nz, ny, nx)))
    pq = be.to_state(0, jax.device_put(p, be.plan.sharding(0, 3)))
    bq = be.to_state(0, jax.device_put(b, be.plan.sharding(0, 3)))
    assert isinstance(pq, QuadField)
    out = be.relax(0, pq, bq, 2)
    assert isinstance(out, QuadField)
    want = np.asarray(relax_compact(p, b, cA_full, 2, "RB", True))
    got = np.asarray(be.to_full(0, out))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)

    # quad persistence pin: the traced sharded relax + residual_restrict on
    # QuadField state contain NO interleave matmuls (merge_quads'
    # minor-axis one-hot scatter lowers to dot_general) — state never
    # leaves quad layout between colors
    jaxpr = jax.make_jaxpr(
        lambda be, p, b: be.relax(0, p, b, 2))(be, pq, bq)
    assert "dot_general" not in str(jaxpr)
    jaxpr = jax.make_jaxpr(
        lambda be, p, b: be.residual_restrict(0, p, b))(be, pq, bq)
    assert "dot_general" not in str(jaxpr)


@needs8
def test_shardmap_tiled_kernels_match_single():
    """The Pallas color-update kernel (interpret mode) on quad-persistent
    SHARDED levels: full distributed solve equals the single-device solve,
    with the sharded levels running the kernel (and its residual-emitting
    variant) on per-device local blocks."""
    nx, ny, nz = 64, 32, 8
    cfg = dict(compact=True, pallas_interpret=True)
    p1, i1 = _solve(nx, ny, nz, cfg_extra=cfg)
    m = NHModel(nx, ny, nz, cfg=SolverConfig(**cfg))
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    m.distribute(4, 2, comm="shard_map")
    be = m.backend
    assert be.plan.shards[0].sharded and be.plan.shards[1].sharded
    assert be.state_quads(0) and be.state_quads(1)
    assert be._use_kernel_shard(0)       # kernel active on level 0
    u, v, w = initial_velocities(nx, ny, nz)
    b = m.rhs(u, v, w)
    p2, i2 = m.pressure_solve(b, tol=1e-10, maxiter=12)
    # this anisotropic grid converges slowly on ONE device too — the
    # contract here is exact agreement with the single-device solve
    assert i2.res < 0.5 * i2.history[0]
    np.testing.assert_allclose(np.asarray(p2), p1, rtol=1e-9,
                               atol=1e-9 * np.abs(p1).max())
    np.testing.assert_allclose(i1.history, i2.history, rtol=1e-4,
                               atol=1e-15)


@needs8
def test_distribute_auto_selects_shard_map_when_compact():
    """comm='auto' (the default) picks the explicit backend whenever a
    sharded level smooths compact — the reference's flagship configuration
    (2x2-decomposed CUC) must keep the fast smoother paths."""
    from mgroms_jax.parallel.shardmap_backend import ShardMapBackend
    from mgroms_jax.parallel.backend import DistributedBackend

    m = NHModel(32, 16, 8, cfg=SolverConfig(compact=True))
    c = setup_seamount(32, 16, 8)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    m.distribute(4, 2)                   # comm='auto'
    assert isinstance(m.backend, ShardMapBackend)

    m2 = NHModel(32, 16, 8, cfg=SolverConfig(compact=False))
    m2.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                    theta_b=c.theta_b, theta_s=c.theta_s)
    m2.distribute(4, 2)
    assert type(m2.backend) is DistributedBackend


@needs8
def test_extend_quads_shard_one_color_update():
    """One compact color update under shard_map (ppermute quad exchange)
    equals the single-device compact color update — pins the distributed
    quad extension including seam and corner values."""
    from mgroms_jax.ops.relax_compact import relax_compact
    from mgroms_jax.parallel.exchange import extend_quads_shard

    nz, ny, nx = 5, 16, 32
    m = NHModel(nx, ny, nz, cfg=SolverConfig(compact=True))
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    m.distribute(4, 2, comm="shard_map")
    cA_blocked = m.backend.ops[0].cA
    cA_full = m.ops[0].cA
    rng = np.random.default_rng(5)
    p = jnp.asarray(rng.standard_normal((nz, ny, nx)))
    b = jnp.asarray(rng.standard_normal((nz, ny, nx)))
    want = np.asarray(relax_compact(p, b, cA_full, 1, "RB", True))

    mesh = m.backend.plan.mesh

    def local(p_l, b_l, cA_l):
        return relax_compact(p_l, b_l, cA_l, 1, "RB", True,
                             extend_fn=extend_quads_shard)

    f = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "py", "px"), P(None, "py", "px"),
                  P(None, None, "py", "px")),
        out_specs=P(None, "py", "px")))
    got = np.asarray(f(p, b, cA_blocked))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
