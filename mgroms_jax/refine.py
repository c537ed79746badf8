"""Mixed-precision defect correction (iterative refinement).

An extension with no reference equivalent: the Fortran reference runs f64
end-to-end (``rp=8``, mg_namelist.f90:8) and its shipped namelist demands
``solver_prec=1e-12`` (src/nh_namelist:3) — unreachable by a pure f32
solve, whose achievable relative residual floors at ~4e-5 on the seamount
case.  Defect correction recovers full f64 accuracy while every multigrid
cycle stays f32 on the accelerator:

    r_k = b - A p_k              float64 (host CPU backend)
    solve A e ~= r_k / s         f32 multigrid F-cycles (accelerator),
                                 s = max|r_k|
    p_{k+1} = p_k + s e          float64

Each round gains the f32 solve's full residual reduction (~4 decades on
seamount), so ~3 rounds reach 1e-12.  The f64 work is one residual +
norm per round — O(1) stencil passes, negligible next to the cycles.

The f64 reference operator lives on the host CPU backend (always available
alongside the accelerator), and the round's data motion is two
(nz, ny, nx) transfers.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .config import SolverConfig
from .model import NHModel
from .solver import solve_p


def require_x64() -> None:
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)


def build_pair(nx: int, ny: int, nz: int, case, cfg32: Optional[SolverConfig]
               = None) -> Tuple[NHModel, NHModel]:
    """Assemble the (f32 solve, f64 reference) model pair from one case.

    The f32 model lives on the default backend; the f64 reference is
    assembled and kept on the host CPU device.  Both see the same f64
    geometry inputs, so the f32 operator is exactly the rounding of the f64
    one.
    """
    require_x64()
    cfg32 = cfg32 or SolverConfig(dtype="float32")
    assert jnp.dtype(cfg32.dtype) == jnp.float32
    m32 = NHModel(nx, ny, nz, cfg=cfg32)
    m32.set_matrices(case.dx, case.dy, case.zeta, case.h, hc=case.hc,
                     theta_b=case.theta_b, theta_s=case.theta_s)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        # the CPU-hosted reference never selects the GPU kernel: its
        # backend's platform (solver._arrays_platform) is the host's
        cfg64 = SolverConfig(
            dtype="float64", compact=cfg32.compact, cmatrix=cfg32.cmatrix,
            bmask=cfg32.bmask, aggressive=cfg32.aggressive)
        m64 = NHModel(nx, ny, nz, cfg=cfg64)
        m64.set_matrices(
            jax.device_put(jnp.asarray(case.dx, jnp.float64), cpu),
            jax.device_put(jnp.asarray(case.dy, jnp.float64), cpu),
            jax.device_put(jnp.asarray(case.zeta, jnp.float64), cpu),
            jax.device_put(jnp.asarray(case.h, jnp.float64), cpu),
            hc=case.hc, theta_b=case.theta_b, theta_s=case.theta_s)
    return m32, m64


class RefineInfo(NamedTuple):
    rounds: int
    res: float                  # final f64 relative residual ||r||/||b||
    history: tuple              # f64 relative residual after each round
    inner_cycles: tuple         # F-cycles spent in each inner f32 solve
    time_s: float


def refined_pressure_solve(m32: NHModel, m64: NHModel, b64: jnp.ndarray,
                           tol: float = 1.0e-12, max_rounds: int = 10,
                           inner_tol: float = 1.0e-4,
                           inner_maxiter: int = 4,
                           verbose: bool = False
                           ) -> Tuple[jnp.ndarray, RefineInfo]:
    """Solve A p = b to f64 accuracy with f32 multigrid cycles.

    ``b64`` must live with the f64 reference model (host CPU).  The inner
    f32 solves run until ``inner_tol`` (the f32 floor) or ``inner_maxiter``
    F-cycles, on the f32 model's backend (the accelerator when attached).
    """
    be64 = m64.backend
    cpu = jax.devices("cpu")[0]
    # COMMIT the inner solve's RHS to the f32 backend's device: an
    # uncommitted/CPU-committed r32 drags the whole jitted f32 solve onto
    # the CPU backend, where the GPU kernel the backend selected cannot
    # lower
    f32dev = next(iter(m32.backend.ops[0].cA.devices()))

    @jax.jit
    def _residual64(be, p, b):
        r = be.residual(0, p, b)
        return r, jnp.sqrt(be.norm_sq(0, r)), jnp.max(jnp.abs(r))

    t0 = time.perf_counter()
    b64 = jax.device_put(jnp.asarray(b64, jnp.float64), cpu)
    bnorm = float(jnp.sqrt(be64.norm_sq(0, b64)))
    p64 = jnp.zeros_like(b64)
    history = []
    inner_cycles = []
    res = float("inf")
    rounds = 0
    for rounds in range(max_rounds + 1):
        r64, rnorm, rmax = _residual64(be64, p64, b64)
        res = float(rnorm) / bnorm
        history.append(res)
        if verbose:
            print(f"refine round {rounds}: f64 rel residual = {res:.3e}")
        if res <= tol or rounds == max_rounds:
            break
        # scale so the f32 inner solve works near unit magnitude (residuals
        # shrink ~4 decades/round; unscaled they would underflow f32)
        s = float(rmax)
        if s == 0.0:
            break
        r32 = jax.device_put(
            jnp.asarray(r64 / s, jnp.float32), f32dev)
        e32, info = solve_p(m32.backend, r32, m32.cfg, tol=inner_tol,
                            maxiter=inner_maxiter)
        inner_cycles.append(info.niter)
        e64 = jax.device_put(jnp.asarray(e32, jnp.float64), cpu) * s
        p64 = p64 + e64
    dt = time.perf_counter() - t0
    return p64, RefineInfo(rounds=rounds, res=res, history=tuple(history),
                           inner_cycles=tuple(inner_cycles), time_s=dt)
