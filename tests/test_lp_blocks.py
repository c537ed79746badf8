"""Low-precision (bf16) smoother blocks for the tiled/XLA compact paths.

The gather blocks are most of the bytes a color update reads, so storing
the SMOOTHER's blocks in bfloat16 halves them.  Convergence safety:
row-sum-consistent rebuilt pivots (relax_compact.consistent_pivots) +
defect-correction outer form (solver.cycle_step).  Residual paths keep the
true f32 operator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgroms_jax.ops.relax_compact import (
    _TKEYS, attach_lp, build_compact_pack, gather_blocks, block_views,
    relax_compact_quads, split_quads)


def _problem(nz, ny, nx, seed=0, dtype=jnp.float32):
    k = jax.random.PRNGKey(seed)
    ks = jax.random.split(k, 3)
    cA = jax.random.uniform(ks[0], (8, nz, ny + 2, nx + 2), dtype,
                            -0.1, 0.1)
    cA = cA.at[0].add(-4.0)
    p = jax.random.normal(ks[1], (nz, ny, nx), dtype)
    b = jax.random.normal(ks[2], (nz, ny, nx), dtype)
    return cA, p, b


@pytest.mark.parametrize("real_matrix", [True, False])
def test_attach_lp_preserves_row_sums(real_matrix):
    """A'·1 == A·1: the rebuilt diagonal compensates the block rounding
    exactly (the property whose violation collapsed convergence in the
    round-3 negative result)."""
    cA, _, _ = _problem(6, 8, 10, dtype=jnp.float32)
    pack = build_compact_pack(cA, real_matrix)
    packl = attach_lp(pack)
    for m, (a, b) in enumerate(_TKEYS):
        nz, H, W = pack.d[m].shape
        ones = jnp.ones((nz, H + 2, W + 2), jnp.float32)
        e1 = {t: ones for t in _TKEYS}
        g = gather_blocks(e1, block_views(pack, m), a, b, real_matrix)
        g_lp = gather_blocks(
            e1, tuple(v.astype(jnp.float32)
                      for v in block_views(packl, m, lp=True)),
            a, b, real_matrix)
        # d' = 1/bet'[0] at the surface (no vertical term from below)
        d2_0 = 1.0 / packl.lp[2][m][0]
        np.testing.assert_allclose(np.asarray(d2_0 + g_lp[0]),
                                   np.asarray(pack.d[m][0] + g[0]),
                                   rtol=2e-6, atol=2e-6)


def test_lp_tiled_interpret_matches_xla():
    """The Pallas kernel reading bf16 blocks (interpret mode) matches the
    XLA compact path on the same lp pack."""
    from mgroms_jax.ops.pallas.relax_tiled import relax_compact_tiled_quads
    cA, p, b = _problem(4, 32, 32, seed=2, dtype=jnp.float32)
    pack = attach_lp(build_compact_pack(cA, True))
    q0, bq = split_quads(p), split_quads(b)
    q_x = relax_compact_quads(q0, bq, pack, 2, "RB", True)
    q_t = relax_compact_tiled_quads(q0, bq, pack, 2, "RB", True,
                                    interpret=True)
    for t in _TKEYS:
        np.testing.assert_allclose(np.asarray(q_t[t]), np.asarray(q_x[t]),
                                   rtol=1e-5, atol=1e-6)


def test_solver_f32_lp_blocks_converge_like_f32():
    """End-to-end f32 solve with fused_bands_bf16 (lp blocks on the
    XLA compact path + defect-correction outer loop) converges to the
    same tolerance in at most one extra cycle."""
    from mgroms_jax import NHModel, SolverConfig
    from mgroms_jax.cases.seamount import initial_velocities, setup_seamount

    def run(**kw):
        m = NHModel(16, 16, 8, cfg=SolverConfig(dtype="float32", **kw))
        c = setup_seamount(16, 16, 8, dtype=jnp.float32)
        m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                       theta_b=c.theta_b, theta_s=c.theta_s)
        u, v, w = initial_velocities(16, 16, 8, dtype=jnp.float32)
        b = m.rhs(u, v, w)
        p, info = m.pressure_solve(b, tol=3e-5, maxiter=12)
        return info

    i_lp = run(fused_bands_bf16=True)
    i_f32 = run()
    assert i_f32.res <= 3e-5
    assert i_lp.res <= 3e-5
    assert i_lp.niter <= i_f32.niter + 1


def test_consistent_pivots_preserve_row_sums():
    """The low-precision smoother operator A' (rounded gather bands +
    rebuilt diagonal) must satisfy A'·1 == A·1 to f32 roundoff — the
    identity (diag = -(row sum) + surface terms, mg_define_matrix.f90:
    615-657) whose violation caused the round-3 convergence collapse."""
    from mgroms_jax.ops.relax_compact import consistent_pivots

    nz, ny, nx = 6, 16, 16
    cA, _, _ = _problem(nz, ny, nx, seed=11, dtype=jnp.float32)
    pack = build_compact_pack(cA, True)
    bet2, gam2 = consistent_pivots(pack, jnp.bfloat16)
    bd = jnp.bfloat16
    for m, (a, b_) in enumerate(_TKEYS):
        nzq, H, W = pack.d[m].shape
        ones = jnp.ones((nzq, H + 2, W + 2), jnp.float32)
        e1 = {t: ones for t in _TKEYS}
        k0 = (jax.lax.broadcasted_iota(jnp.int32, (nzq, 1, 1), 0) == 0
              ).astype(jnp.float32)
        # recover d' from the returned pivots: bet' = 1/d' at k=0
        d2_k0 = 1.0 / bet2[m][0]
        blks = block_views(pack, m)
        rounded = tuple(x.astype(bd).astype(jnp.float32) for x in blks)
        s_orig = gather_blocks(e1, blks, a, b_, True, k0)
        s_round = gather_blocks(e1, rounded, a, b_, True, k0)
        # row sum at k=0 (no vertical term from below): d + s must match
        np.testing.assert_allclose(
            np.asarray(d2_k0 + s_round[0]),
            np.asarray(pack.d[m][0] + s_orig[0]), rtol=2e-6, atol=2e-6)


def test_solver_bf16_bands_convergence_matches_f32():
    """End-to-end with fused_bands_bf16 (bf16 blocks read by the Pallas
    kernel in interpret mode): the consistent perturbed smoother must
    converge like the f32 one (same iteration count to tolerance +1;
    round 3's inconsistent variant stalled at rel residual ~0.17)."""
    from mgroms_jax import NHModel, SolverConfig
    from mgroms_jax.cases.seamount import initial_velocities, setup_seamount

    def run(**kw):
        m = NHModel(16, 16, 16, cfg=SolverConfig(dtype="float32",
                                                 solver_prec=1e-4, **kw))
        c = setup_seamount(16, 16, 16)
        m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                       theta_b=c.theta_b, theta_s=c.theta_s)
        u, v, w = initial_velocities(16, 16, 16)
        return m, m.solve(u, v, w)

    m1, (_, _, _, _, info1) = run(pallas_interpret=True,
                                  fused_bands_bf16=True)
    assert any(pk is not None and pk.lp is not None
               and pk.lp[0][0].dtype == jnp.bfloat16
               for pk in m1.backend.packs), \
        "low-precision smoother operator never built"
    m0, (_, _, _, _, info0) = run()
    assert info0.res <= 1e-4
    assert info1.res <= 1e-4, (info1.res, info1.history)
    assert info1.niter <= info0.niter + 1, (info1.history, info0.history)


if __name__ == "__main__":
    pytest.main([__file__, "-q"])
