import jax.numpy as jnp
import numpy as np

from mgroms_jax.bc import extend_h1, extend_h2


def test_extend_h1_mirror():
    a = jnp.arange(12.0).reshape(3, 4)
    e = extend_h1(a)
    assert e.shape == (5, 6)
    np.testing.assert_array_equal(e[1:-1, 1:-1], a)
    # edge copy (mirror with nh=1)
    np.testing.assert_array_equal(e[0, 1:-1], a[0])
    np.testing.assert_array_equal(e[-1, 1:-1], a[-1])
    np.testing.assert_array_equal(e[1:-1, 0], a[:, 0])
    # corner = double mirror
    assert e[0, 0] == a[0, 0]
    assert e[-1, -1] == a[-1, -1]


def test_extend_h2_rules():
    ny, nx = 5, 6
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((ny, nx)))
    e = np.asarray(extend_h2(a))
    a = np.asarray(a)
    assert e.shape == (ny + 4, nx + 4)
    np.testing.assert_array_equal(e[2:-2, 2:-2], a)
    # south edge (interior columns): first halo = edge, second = 2*edge - next
    np.testing.assert_allclose(e[1, 2:-2], a[0])
    np.testing.assert_allclose(e[0, 2:-2], 2 * a[0] - a[1])
    # east edge
    np.testing.assert_allclose(e[2:-2, -2], a[:, -1])
    np.testing.assert_allclose(e[2:-2, -1], 2 * a[:, -1] - a[:, -2])
    # corner blocks are pure double mirror (mg_mpi_exchange.f90:1041-1077):
    # halo distance d maps to interior index d-1
    np.testing.assert_allclose(e[1, 1], a[0, 0])
    np.testing.assert_allclose(e[0, 0], a[1, 1])
    np.testing.assert_allclose(e[0, 1], a[1, 0])
    np.testing.assert_allclose(e[1, 0], a[0, 1])
    np.testing.assert_allclose(e[-1, -1], a[-2, -2])
    np.testing.assert_allclose(e[-2, -1], a[-1, -2])
    np.testing.assert_allclose(e[0, -1], a[1, -2])
    np.testing.assert_allclose(e[-1, 0], a[-2, 1])


def test_extend_h2_3d():
    a = jnp.asarray(np.random.default_rng(1).standard_normal((3, 4, 5)))
    e = extend_h2(a)
    assert e.shape == (3, 8, 9)
    np.testing.assert_array_equal(np.asarray(e)[:, 2:-2, 2:-2], np.asarray(a))
