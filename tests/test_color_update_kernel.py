"""The Pallas color-update kernel, one target quad at a time, against the
XLA compact smoother's color update (interpret mode on CPU).

Parametrised over the four red-black target quads, both ``cmatrix``
flavours, float32 and bfloat16 gather blocks (pack.lp), and a width that
needs padding in one tile as well as a forced multi-tile grid whose last
tiles overhang both edges.  Each case checks the plain update and the
residual-emitting variant.  The compiled kernel is checked on the card by
chip_smoke.py and by the ``gpu``-marked test below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgroms_jax.ops.pallas.relax_tiled import (_gather_quads,
                                               color_update_tiled, pick_tile)
from mgroms_jax.ops.relax import tridiag_factored
from mgroms_jax.ops.relax_compact import (_TKEYS, attach_lp, block_views,
                                          build_compact_pack, extend_quads,
                                          gather_blocks, residual_from_gather,
                                          smoother_operator, split_quads)


def _problem(nz, ny, nx, seed, dtype):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    cA = jax.random.uniform(ks[0], (8, nz, ny + 2, nx + 2), dtype,
                            -0.1, 0.1).at[0].add(-4.0)
    p = jax.random.normal(ks[1], (nz, ny, nx), dtype)
    b = jax.random.normal(ks[2], (nz, ny, nx), dtype)
    return cA, p, b


# (ny, nx, tile): one tile padded past W=5 and H=7; a forced 2x3 tile grid
# whose last row and column of tiles overhang H=9 and W=11
WIDTHS = {"padded": (14, 10, None), "multitile": (18, 22, (4, 4))}


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("blocks", ["f32", "bf16"])
@pytest.mark.parametrize("real_matrix", [True, False])
@pytest.mark.parametrize("target", _TKEYS)
def test_kernel_color_update_matches_xla(target, real_matrix, blocks,
                                         width):
    ny, nx, tile = WIDTHS[width]
    nz = 5
    cA, p, b = _problem(nz, ny, nx, seed=sum(target) + 3 * real_matrix,
                        dtype=jnp.float32)
    pack = build_compact_pack(cA, real_matrix)
    if blocks == "bf16":
        pack = attach_lp(pack)
    m = _TKEYS.index(target)
    q, bq = split_quads(p), split_quads(b)
    e = extend_quads(q)
    e3 = tuple(e[k] for k in _gather_quads(target))

    # XLA reference: the color update of relax_compact_quads for this target
    views, bet, gam = smoother_operator(pack, m)
    g = gather_blocks(e, views, target[0], target[1], real_matrix)
    want = tridiag_factored(bet, gam, pack.ud[m], bq[target] - g)

    rblocks = (pack.lp[1] if blocks == "bf16" else pack.rblocks) \
        if real_matrix else None
    wide, bet_k = ((pack.lp[0][m], pack.lp[2][m]) if blocks == "bf16"
                   else (pack.blocks[m], pack.bet[m]))
    got = color_update_tiled(e3, bq[target], wide, pack.ud[m], bet_k,
                             target, real_matrix, interpret=True,
                             rb_t=rblocks[m] if real_matrix else None,
                             tile=tile)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)

    if blocks == "f32":
        # the emitting variant: same update + r = b - D x - g (true A)
        g32 = gather_blocks(e, block_views(pack, m), target[0], target[1],
                            real_matrix)
        sol, res = color_update_tiled(
            e3, bq[target], pack.blocks[m], pack.ud[m], pack.bet[m], target,
            real_matrix, interpret=True,
            rb_t=pack.rblocks[m] if real_matrix else None, d_t=pack.d[m],
            tile=tile)
        r_want = residual_from_gather(bq[target], want, pack, m, g32)
        np.testing.assert_allclose(np.asarray(sol), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(res), np.asarray(r_want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,W", [(512, 512), (16, 16), (7, 5), (3, 300)])
def test_pick_tile_is_pow2_and_covers(H, W):
    tj, tw = pick_tile(H, W)
    assert tj & (tj - 1) == 0 and tw & (tw - 1) == 0
    assert tw <= 128 and tj * tw <= 512
    # one tile never overshoots an axis by a whole tile
    assert tw < 2 * W and tj < 2 * H


@pytest.fixture
def gpu():
    """The default device if it is a GPU; skips the test elsewhere
    (decided when the test runs, never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a CUDA GPU (on the card: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/)")
    return dev


@pytest.mark.gpu
def test_kernel_compiled_matches_xla_on_gpu(gpu):
    """The kernel compiled by Triton (no interpret mode) against the XLA
    color update, float32, a few tiles wide."""
    target, real = (0, 1), True
    cA, p, b = _problem(16, 64, 96, seed=1, dtype=jnp.float32)
    pack = build_compact_pack(cA, real)
    m = _TKEYS.index(target)
    q, bq = split_quads(p), split_quads(b)
    e = extend_quads(q)
    g = gather_blocks(e, block_views(pack, m), target[0], target[1], real)
    want = tridiag_factored(pack.bet[m], pack.gam[m], pack.ud[m],
                            bq[target] - g)
    got = color_update_tiled(tuple(e[k] for k in _gather_quads(target)),
                             bq[target], pack.blocks[m], pack.ud[m],
                             pack.bet[m], target, real,
                             rb_t=pack.rblocks[m])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
