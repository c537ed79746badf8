"""Benchmark driver: seamount solve throughput on the current backend.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Headline metric: multigrid throughput in DOF/s — fine-grid degrees of
freedom processed per second of F-cycle (each F-cycle visits every level).
Also reports the reference's own "rescaled performance" (core-seconds per
DOF per decade of residual reduction, src/mg_solvers.f90:84-97; lower is
better) and cycles to tolerance.

Everything runs in this one process (one JAX process per card), on a GPU
only: with none it exits without a result.  The seamount row is 64^3
float32 and two CUC 1024^2 x 64 rows follow (parity and perf mode,
scripts/bench_case.run_case).  Timing: warm-up,
then back-to-back F-cycles ended by ``jax.block_until_ready``
(utils/timing.time_device_fn), median of several batches.

The reference publishes no numbers (BASELINE.md: `published: {}`), so
vs_baseline is 1.0 by definition.
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp


def main():
    from mgroms_jax.platform import (card_info, enable_compile_cache,
                                     kernel_allowed, require_gpu)
    dev = require_gpu()
    cache_dir = enable_compile_cache()
    nx = ny = nz = 64
    dtype = "float32"
    tol = 1e-4          # f32 relative-residual floor is ~4e-5

    from mgroms_jax import NHModel, SolverConfig
    from mgroms_jax.cases.seamount import initial_velocities, setup_seamount
    from mgroms_jax.solver import cycle_step
    from mgroms_jax.utils.timing import time_device_fn

    cfg = SolverConfig(dtype=dtype, coarsest="direct")
    m = NHModel(nx, ny, nz, cfg=cfg)
    c = setup_seamount(nx, ny, nz, dtype=jnp.dtype(dtype))
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    u, v, w = initial_velocities(nx, ny, nz, dtype=jnp.dtype(dtype))
    b = m.rhs(u, v, w)
    be = m.backend

    MAXC = 24

    @jax.jit
    def run(be, b, n):
        """n F-cycles from p=0, recording ||r||/||b|| after each.  State
        (p, b, r) rides in level 0's canonical layout (QuadField on
        quad-persistent levels) exactly like solver.solve_step."""
        q = bool(getattr(be, "state_quads", lambda lev: False)(0))
        to_state = getattr(be, "to_state", lambda lev, x: x)
        p = be.zeros(0, as_quads=q)
        bs = to_state(0, b)
        r = be.residual(0, p, bs)
        bnorm = jnp.sqrt(be.norm_sq(0, b))
        hist0 = jnp.zeros((MAXC + 1,), dtype=b.dtype)
        hist0 = hist0.at[0].set(jnp.sqrt(be.norm_sq(0, r)) / bnorm)

        def body(i, state):
            p, r, hist = state
            p, r = cycle_step(be, p, bs, r, cfg)
            hist = hist.at[i + 1].set(jnp.sqrt(be.norm_sq(0, r)) / bnorm)
            return (p, r, hist)

        p, r, hist = jax.lax.fori_loop(0, n, body, (p, r, hist0))
        return hist

    # convergence history (one dispatch)
    hist = [float(h) for h in run(be, b, jnp.int32(12))][:13]
    res0 = hist[0]
    ncyc = next((i for i, h in enumerate(hist) if h <= tol and i > 0), 12)
    res = hist[min(ncyc, 12)]

    # timing: warm-up, then `reps` back-to-back F-cycles ended by
    # block_until_ready; the MEDIAN of `nbatch` batches is reported
    from mgroms_jax.solver import solve_init, solve_step
    p, bs, r, _, _ = solve_init(be, b)

    def step(c, be, bs):
        # the solve's own compiled program (one F-cycle + residual + norm)
        p, r, _ = solve_step(be, c[0], bs, c[1], cfg)
        return p, r

    reps = 20
    nbatch = 5
    batches = sorted(time_device_fn(step, (p, r), iters=reps,
                                    args=(be, bs), jit=False)
                     for _ in range(nbatch))
    dt = batches[len(batches) // 2]

    dof = nx * ny * nz
    decades = -math.log10(max(res / res0, 1e-300))
    rescaled = (ncyc * dt) / max(decades, 1e-9) / dof

    spread = (batches[-1] - batches[0]) / dt
    extra = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "card": card_info(),          # nvidia-smi name, power.limit
        "dtype": dtype,
        "grid": [nz, ny, nx],
        "fcycle_seconds": dt,
        "timing_method": f"median of {len(batches)} batches of {reps} "
                         "back-to-back F-cycles after a warm-up call, "
                         "ended by jax.block_until_ready",
        "batch_fcycle_seconds": batches,
        "batch_spread_rel": spread,
        "cycles_to_tol": ncyc,
        "tol": tol,
        "final_rel_residual": res,
        "residual_history": hist[:10],
        "rescaled_perf_core_s_per_dof_per_decade": rescaled,
        "compile_cache_dir": cache_dir,
        # the measured program's configuration (beyond-reference options on)
        "config": {
            "coarsest": cfg.coarsest,
            "compact": cfg.compact,
            "pallas_kernel": kernel_allowed(be.platform, cfg),
            "tridiag": cfg.tridiag,
            "relax_kind": cfg.relax_kind,
            "cycle": "fcycle(keep_state=True); state in quad layout on "
                     "quad-persistent levels",
        },
    }
    del m, be, b, bs, p, r

    # flagship-scale rows (CUC 1024^2 x 64, the reference's testcuc grid),
    # in this process: MGROMS_BENCH_CUC=0 opts out
    if os.environ.get("MGROMS_BENCH_CUC", "1") != "0":
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "scripts"))
        from bench_case import run_case
        cuc = dict(case="cuc", nx=1024, ny=1024, nz=64, reps=5)
        extra["cuc_1024x1024x64"] = run_case(**cuc)
        # perf mode: bf16 smoother blocks (consistent pivots +
        # defect-correction outer loop, converges to the same f32 floor)
        # + the lighter V(1,1) schedule; parity keeps the reference 3/2
        # and the f32 operator (the row above)
        extra["cuc_1024x1024x64_perf"] = run_case(
            **cuc, bf16_bands=True, ns_pre=1, ns_post=1)

    print(json.dumps({
        "metric": f"seamount{nx}_fcycle_dof_per_s",
        "value": dof / dt,
        "unit": "dof/s",
        "vs_baseline": 1.0,
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
