"""The Pallas color-update kernel == its XLA reference (interpret mode on
CPU).

The kernel compiles for CUDA GPUs through Triton; the backend selects it
there only (platform.kernel_allowed), so these interpret-mode checks are
the CPU coverage of its arithmetic, and chip_smoke.py checks the compiled
kernel on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mgroms_jax import NHModel, SolverConfig
from mgroms_jax.bc import extend_h1
from mgroms_jax.cases.seamount import setup_seamount
from mgroms_jax.ops import stencil
from mgroms_jax.ops.relax_compact import build_compact_pack, relax_compact
from mgroms_jax.ops.pallas.relax_tiled import relax_compact_tiled


def _operator(nx, ny, nz):
    m = NHModel(nx, ny, nz, cfg=SolverConfig())
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m.ops[0].cA


def test_relax_tiled_matches_compact():
    nz, ny, nx = 8, 32, 64
    cA = _operator(nx, ny, nz)
    rng = np.random.default_rng(1)
    p = jnp.asarray(rng.standard_normal((nz, ny, nx)))
    b = jnp.asarray(rng.standard_normal((nz, ny, nx)))
    for kind in ("RB", "FC"):
        pack = build_compact_pack(cA, True)
        want = relax_compact(p, b, cA, 2, kind, True, pack=pack)
        got = relax_compact_tiled(p, b, pack, 2, kind, True, interpret=True)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-13, atol=1e-13)


def test_relax_tiled_builds_pack_from_bands():
    """Fallback path: relax_compact_tiled(pack=None, cA=...) matches."""
    nz, ny, nx = 4, 16, 16
    cA = _operator(nx, ny, nz)
    rng = np.random.default_rng(3)
    p = jnp.asarray(rng.standard_normal((nz, ny, nx)))
    b = jnp.asarray(rng.standard_normal((nz, ny, nx)))
    want = relax_compact(p, b, cA, 1, "RB", True)
    got = relax_compact_tiled(p, b, None, 1, "RB", True, interpret=True,
                              cA=cA)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-13, atol=1e-13)


def test_residual_restrict_tiled_matches_pair():
    """The down-leg pair on quad state (XLA quad residual + the quad-read
    restriction, the path the kernel's levels take) ==
    transfer.restrict(stencil.residual) — identical summation tree, so
    equality is to rounding."""
    from mgroms_jax.ops.relax_compact import (residual_quads,
                                              restrict_quads_to_full,
                                              split_quads)
    from mgroms_jax.ops.transfer import restrict
    nz, ny, nx = 8, 32, 64
    cA = _operator(nx, ny, nz)
    rng = np.random.default_rng(5)
    p = jnp.asarray(rng.standard_normal((nz, ny, nx)))
    b = jnp.asarray(rng.standard_normal((nz, ny, nx)))
    want = restrict(stencil.residual(extend_h1(p), b, cA, True))
    pack = build_compact_pack(cA, True)
    got = restrict_quads_to_full(residual_quads(split_quads(p),
                                                split_quads(b), pack, True))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


def test_thomas_factored_bitwise():
    """Precomputed-pivot substitution (scan form) is BITWISE-equal to the
    sequential Thomas for nz >= 2 (same op order — the smoother's
    division-free hot path must not move the iterates); nz==1 differs by
    one rounding (b*(1/d) vs b/d) and is unreachable on compact (nd==8)
    levels."""
    from mgroms_jax.ops.relax import thomas_factor, tridiag, tridiag_factored
    rng = np.random.default_rng(4)
    for nz in (2, 8, 64):
        d = jnp.asarray(rng.uniform(2.0, 3.0, (nz, 4, 8)))
        ud = jnp.asarray(rng.uniform(-1.0, -0.5, (nz - 1, 4, 8)))
        b = jnp.asarray(rng.standard_normal((nz, 4, 8)))
        bet, gam = thomas_factor(d, ud)
        ref = np.asarray(tridiag(d, ud, b))
        np.testing.assert_array_equal(
            np.asarray(tridiag_factored(bet, gam, ud, b)), ref)
