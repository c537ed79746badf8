"""The platform gate, the compile-cache helper, and the GPU-facing numerics
of the plain paths (precision of the coarse solve, the interleave)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgroms_jax import NHModel, SolverConfig
from mgroms_jax import platform as plat
from mgroms_jax.cases.seamount import setup_seamount
from mgroms_jax.solver import SingleDeviceBackend


@pytest.mark.parametrize("platform,dtype,interpret,want", [
    ("gpu", "float32", False, True),     # the card, float32: the kernel
    ("gpu", "float64", False, False),    # float64 stays on XLA
    ("cpu", "float32", False, False),    # never implied by the platform
    ("other", "float32", False, False),  # no kernel for any other backend
    ("cpu", "float64", True, True),      # interpret mode only on request
])
def test_kernel_gate(platform, dtype, interpret, want):
    cfg = SolverConfig(dtype=dtype, pallas_interpret=interpret)
    assert plat.kernel_allowed(platform, cfg) is want
    off = dataclasses.replace(cfg, pallas_kernel=False)
    assert plat.kernel_allowed(platform, off) is False


def test_default_dtype_by_platform():
    assert plat.default_dtype("cpu") == "float64"
    assert plat.default_dtype("gpu") == "float32"


def _model(nx=16, ny=16, nz=8, **kw):
    m = NHModel(nx, ny, nz, cfg=SolverConfig(**kw))
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


def _pallas_params(jaxpr):
    """(interpret, backend) of every pallas_call in a jaxpr, nested ones
    included."""
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "pallas_call":
                out.append((eqn.params["interpret"],
                            eqn.params.get("backend")))
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                    if isinstance(sub, jax.extend.core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jax.extend.core.Jaxpr):
                        walk(sub)
    walk(jaxpr.jaxpr)
    return out


def test_interpret_never_implicit():
    """A GPU-placed backend traces the Triton kernel in compiled mode; the
    same operators on the CPU take the XLA path (no pallas_call at all);
    interpret mode appears only when the configuration asks for it."""
    m = _model(dtype="float32")
    lev = 0
    q = m.backend.to_state(lev, m.backend.zeros(lev))

    def relax(be):
        return jax.make_jaxpr(lambda be, p, b: be.relax(lev, p, b, 1))(
            be, q, q)

    on_gpu = SingleDeviceBackend(m.levels, m.ops, m.cfg, platform="gpu",
                                 packs=m.backend.packs)
    assert _pallas_params(relax(on_gpu)) \
        and all(p == (False, "triton") for p in _pallas_params(relax(on_gpu)))
    assert plat.is_host(m.backend.platform)
    assert _pallas_params(relax(m.backend)) == []
    cfg_i = dataclasses.replace(m.cfg, pallas_interpret=True)
    interp = SingleDeviceBackend(m.levels, m.ops, cfg_i,
                                 packs=m.backend.packs)
    assert all(p[0] is True for p in _pallas_params(relax(interp)))


def test_compile_cache_uses_env_dir_when_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert plat.enable_compile_cache() == str(tmp_path)
    # the helper leaves the directory to JAX and sets none itself
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_checkout_path_when_unset(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = plat.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            plat.__file__)))
        assert got == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert plat.enable_compile_cache() == got     # fixed, not per run
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_coarse_direct_solve_runs_at_highest_precision():
    """The coarse solve Ainv @ b asks for HIGHEST precision, so a float32
    product on a GPU never drops to TF32."""
    m = _model(dtype="float32", coarsest="direct")
    be = m.backend
    L = be.nlevels if hasattr(be, "nlevels") else be.nlevs
    s = be.levels[L - 1]
    b = jnp.ones((s.nzg, s.nyg, s.nxg), jnp.float32)
    jx = jax.make_jaxpr(lambda be, b: be.relax(L - 1, b, b, 1))(be, b)
    dots = [e for e in jx.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots, "coarse direct solve is not a matmul"
    assert all(str(e.params["precision"]).count("HIGHEST") == 2
               for e in dots), [e.params["precision"] for e in dots]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_interleave_x_equals_one_hot_matmul_form(dtype):
    """The x interleave (stack + reshape) is bit-for-bit the one-hot
    scatter-matmul form it replaces."""
    from mgroms_jax.ops.transfer import _interleave
    rng = np.random.default_rng(0)
    a0 = jnp.asarray(rng.standard_normal((3, 4, 6)), dtype)
    a1 = jnp.asarray(rng.standard_normal((3, 4, 6)), dtype)
    n = a0.shape[-1]

    def scatter(phase):
        cols = jnp.arange(2 * n)
        rows = jnp.arange(n)[:, None]
        return (cols[None, :] == 2 * rows + phase).astype(dtype)

    hp = jax.lax.Precision.HIGHEST
    old = (jnp.matmul(a0, scatter(0), precision=hp)
           + jnp.matmul(a1, scatter(1), precision=hp))
    np.testing.assert_array_equal(np.asarray(_interleave(a0, a1, -1)),
                                  np.asarray(old))


def test_merge_quads_inverts_split_exactly():
    from mgroms_jax.ops.relax_compact import merge_quads, split_quads
    x = jnp.asarray(np.random.default_rng(1).standard_normal((4, 10, 14)))
    np.testing.assert_array_equal(np.asarray(merge_quads(split_quads(x))),
                                  np.asarray(x))
