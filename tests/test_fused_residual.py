"""Fused relax+residual (cfg.fused_residual): parity pins.

The fused paths reproduce relax-then-residual / relax-then-
residual_restrict EXACTLY in exact arithmetic: the last color's residual
reuses the gather its own line solve consumed (the opposite-color state
it read does not change after the last color); the boundary mirror ring
and the 'real' plane-0 same-color couplings are re-evaluated fresh
(relax_compact._patch_emitted_residual), term for term in residual_quads
order.  The only implementation noise is ~1 ulp from XLA compiling the
peeled final sweep outside the multi-sweep fori_loop (different fusion
choices) — pinned here at 1e-13-relative tightness.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgroms_jax.ops.relax_compact import (
    _TKEYS, build_compact_pack, merge_quads, relax_compact_quads,
    relax_residual_compact_quads, relax_residual_restrict_compact_quads,
    residual_quads, restrict_quads_to_full, split_quads)


def _problem(nz, ny, nx, seed=0, dtype=jnp.float64):
    k = jax.random.PRNGKey(seed)
    ks = jax.random.split(k, 3)
    cA = jax.random.uniform(ks[0], (8, nz, ny + 2, nx + 2), dtype,
                            -0.1, 0.1)
    cA = cA.at[0].add(-4.0)
    p = jax.random.normal(ks[1], (nz, ny, nx), dtype)
    b = jax.random.normal(ks[2], (nz, ny, nx), dtype)
    return cA, p, b


@pytest.mark.parametrize("real_matrix", [True, False])
@pytest.mark.parametrize("nsweeps", [1, 3])
def test_fused_residual_bitwise_xla(real_matrix, nsweeps):
    nz, ny, nx = 6, 8, 10
    cA, p, b = _problem(nz, ny, nx, seed=5)
    pack = build_compact_pack(cA, real_matrix)
    q0, bq = split_quads(p), split_quads(b)

    q_ref = relax_compact_quads(q0, bq, pack, nsweeps, "RB", real_matrix)
    r_ref = residual_quads(q_ref, bq, pack, real_matrix)
    q_f, r_f = relax_residual_compact_quads(q0, bq, pack, nsweeps,
                                            real_matrix)
    for t in _TKEYS:
        np.testing.assert_allclose(np.asarray(q_f[t]), np.asarray(q_ref[t]),
                                   rtol=1e-13, atol=1e-15)
        # residuals at just-updated columns are O(roundoff) themselves;
        # compare at absolute roundoff scale of the O(1) operands
        np.testing.assert_allclose(np.asarray(r_f[t]), np.asarray(r_ref[t]),
                                   rtol=1e-12, atol=1e-13)
    if nsweeps == 1:
        # no peeled-loop recompilation with a single sweep: exact
        for t in _TKEYS:
            assert np.array_equal(np.asarray(q_f[t]), np.asarray(q_ref[t]))


@pytest.mark.parametrize("real_matrix", [True, False])
def test_fused_residual_restrict_bitwise_xla(real_matrix):
    nz, ny, nx = 6, 8, 10
    cA, p, b = _problem(nz, ny, nx, seed=6)
    pack = build_compact_pack(cA, real_matrix)
    q0, bq = split_quads(p), split_quads(b)

    q_ref = relax_compact_quads(q0, bq, pack, 2, "RB", real_matrix)
    cb_ref = restrict_quads_to_full(
        residual_quads(q_ref, bq, pack, real_matrix))
    q_f, cb_f = relax_residual_restrict_compact_quads(q0, bq, pack, 2,
                                                      real_matrix)
    for t in _TKEYS:
        np.testing.assert_allclose(np.asarray(q_f[t]), np.asarray(q_ref[t]),
                                   rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(np.asarray(cb_f), np.asarray(cb_ref),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("real_matrix", [True, False])
def test_fused_residual_tiled_interpret_matches_xla(real_matrix):
    """The Pallas emit kernel (interpret mode on CPU) against the XLA
    fused path — covers _kernel_emit's in-kernel residual expression."""
    from mgroms_jax.ops.pallas.relax_tiled import (
        relax_residual_restrict_tiled_quads, relax_residual_tiled_quads)
    nz, ny, nx = 4, 16, 16
    cA, p, b = _problem(nz, ny, nx, seed=7)
    pack = build_compact_pack(cA, real_matrix)
    q0, bq = split_quads(p), split_quads(b)

    q_x, r_x = relax_residual_compact_quads(q0, bq, pack, 2, real_matrix)
    q_t, r_t = relax_residual_tiled_quads(q0, bq, pack, 2, real_matrix,
                                          interpret=True)
    for t in _TKEYS:
        np.testing.assert_allclose(np.asarray(q_t[t]), np.asarray(q_x[t]),
                                   rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(np.asarray(r_t[t]), np.asarray(r_x[t]),
                                   rtol=1e-12, atol=1e-13)

    _, cb_x = relax_residual_restrict_compact_quads(q0, bq, pack, 2,
                                                    real_matrix)
    _, cb_t = relax_residual_restrict_tiled_quads(q0, bq, pack, 2,
                                                  real_matrix,
                                                  interpret=True)
    np.testing.assert_allclose(np.asarray(cb_t), np.asarray(cb_x),
                               rtol=1e-12, atol=1e-13)


def test_solver_history_unchanged_by_fused_residual():
    """End-to-end: the f64 seamount solve history with cfg.fused_residual
    tracks the plain path to roundoff (identical in exact arithmetic;
    ulp-level XLA recompilation noise only)."""
    from mgroms_jax import NHModel, SolverConfig
    from mgroms_jax.cases.seamount import initial_velocities, setup_seamount

    def run(**kw):
        m = NHModel(16, 16, 16, cfg=SolverConfig(**kw))
        c = setup_seamount(16, 16, 16)
        m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                       theta_b=c.theta_b, theta_s=c.theta_s)
        u, v, w = initial_velocities(16, 16, 16)
        b = m.rhs(u, v, w)
        p, info = m.pressure_solve(b, tol=1e-11, maxiter=12)
        return np.asarray(p), info

    p1, i1 = run(fused_residual=True)
    p0, i0 = run(fused_residual=False)
    assert i1.res <= 1e-11 and i0.res <= 1e-11
    n = min(len(i1.history), len(i0.history))
    np.testing.assert_allclose(np.array(i1.history[:n]),
                               np.array(i0.history[:n]),
                               rtol=1e-6, atol=1e-14)
    np.testing.assert_allclose(p1, p0, rtol=1e-10,
                               atol=1e-12 * np.abs(p0).max())


if __name__ == "__main__":
    pytest.main([__file__, "-q"])
