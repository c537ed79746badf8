"""F-cycle time for any case, size and configuration on one GPU.

    python scripts/bench_case.py --case seamount --nx 64 --ny 64 --nz 64
    python scripts/bench_case.py --case cuc --nx 1024 --ny 1024 --nz 64
    python scripts/bench_case.py --case cuc --nx 1024 --ny 1024 --nz 64 \\
        --bf16-bands --ns-pre 1 --ns-post 1        # perf mode
    python scripts/bench_case.py --case seamount --refine

Prints one JSON line.  Timing: one warm-up F-cycle (compilation), then
``--reps`` back-to-back F-cycles ended by ``jax.block_until_ready``
(utils/timing.time_device_fn).  Every row records the device kind and the
card's name and power limit.  ``bench.py`` calls :func:`run_case` in its
own process for its CUC rows.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax
import jax.numpy as jnp


def _setup(case: str, nx: int, ny: int, nz: int, dt):
    if case == "seamount":
        from mgroms_jax.cases.seamount import setup_seamount
        return setup_seamount(nx, ny, nz, dtype=dt)
    if case == "rndtopo":
        from mgroms_jax.cases.rndtopo import setup_rndtopo
        return setup_rndtopo(nx, ny, nz, dtype=dt)
    from mgroms_jax.cases.cuc import setup_cuc_synthetic
    return setup_cuc_synthetic(nx, ny, nz, dtype=dt)


def run_case(case: str = "seamount", nx: int = 64, ny: int = 64,
             nz: int = 64, dtype: str = "float32", reps: int = 10,
             compact: bool = True, kernel: bool = True,
             bf16_bands: bool = False, ns_pre=None, ns_post=None,
             coarsest: str = "direct", tridiag: str = "thomas") -> dict:
    """Time ``reps`` F-cycles of one configuration; returns the row."""
    from mgroms_jax import NHModel, SolverConfig
    from mgroms_jax.cases.seamount import initial_velocities
    from mgroms_jax.platform import card_info, kernel_allowed
    from mgroms_jax.solver import solve_init, solve_step
    from mgroms_jax.utils.timing import time_device_fn

    dt = jnp.dtype(dtype)
    sched = {k: v for k, v in (("ns_pre", ns_pre), ("ns_post", ns_post))
             if v is not None}
    cfg = SolverConfig(dtype=dtype, compact=compact, pallas_kernel=kernel,
                       coarsest=coarsest, tridiag=tridiag,
                       fused_bands_bf16=bf16_bands, **sched)
    c = _setup(case, nx, ny, nz, dt)
    m = NHModel(nx, ny, nz, cfg=cfg)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    u, v, w = initial_velocities(nx, ny, nz, dtype=dt)
    b = m.rhs(u, v, w)
    del u, v, w, c
    be = m.backend
    p, bs, r, _, bnorm = solve_init(be, b)

    def step(c, be, bs):
        # the solve's own compiled program (one F-cycle + residual + norm)
        p, r, _ = solve_step(be, c[0], bs, c[1], cfg)
        return p, r

    t = time_device_fn(step, (p, r), iters=reps, args=(be, bs), jit=False)
    p, r = step((p, r), be, bs)
    res = float(jnp.sqrt(be.norm_sq(0, r)) / bnorm)
    dev = jax.devices()[0]
    return {
        "case": case, "grid": [nz, ny, nx], "dtype": dtype,
        "compact": compact, "kernel": kernel_allowed(be.platform, cfg),
        "tridiag": tridiag, "bf16_bands": bf16_bands,
        "ns_pre": cfg.ns_pre, "ns_post": cfg.ns_post,
        "coarsest": coarsest,
        "fcycle_ms": t * 1e3,
        "mdof_per_s": nx * ny * nz / t / 1e6,
        "reps": reps,
        # residual after the warm-up, the timed cycles and one more
        "rel_residual_after": res, "cycles_run": reps + 2,
        "platform": dev.platform, "device_kind": dev.device_kind,
        "card": card_info(),
    }


def run_refine(case: str, nx: int, ny: int, nz: int, compact: bool = True,
               coarsest: str = "direct") -> dict:
    """Mixed-precision defect correction: f32 cycles on the device, f64
    residuals on the host CPU, to 1e-12."""
    from mgroms_jax import SolverConfig
    from mgroms_jax.cases.seamount import initial_velocities
    from mgroms_jax.platform import card_info
    from mgroms_jax.refine import (build_pair, refined_pressure_solve,
                                   require_x64)

    require_x64()        # before any f64 array is created
    c = _setup(case, nx, ny, nz, jnp.float64)
    cfg32 = SolverConfig(dtype="float32", compact=compact, coarsest=coarsest)
    m32, m64 = build_pair(nx, ny, nz, c, cfg32)
    u, v, w = initial_velocities(nx, ny, nz, dtype=jnp.float64)
    b64 = m64.rhs(u, v, w)
    p64, info = refined_pressure_solve(m32, m64, b64, tol=1e-12,
                                       max_rounds=8, verbose=True)
    dev = jax.devices()[0]
    return {
        "case": case, "grid": [nz, ny, nx],
        "mode": "defect-correction f32 cycles + f64 residuals",
        "rounds": info.rounds, "final_f64_rel_residual": info.res,
        "history": [float(h) for h in info.history],
        "inner_fcycles": list(info.inner_cycles),
        "time_s": info.time_s,
        "platform": dev.platform, "device_kind": dev.device_kind,
        "card": card_info(),
    }


def main():
    from mgroms_jax.platform import enable_compile_cache, require_gpu
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", default="seamount",
                    choices=["seamount", "cuc", "rndtopo"])
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-compact", action="store_true",
                    help="masked RB smoother instead of the compact one")
    ap.add_argument("--no-kernel", action="store_true",
                    help="XLA color update instead of the Pallas kernel")
    ap.add_argument("--bf16-bands", action="store_true",
                    help="bfloat16 smoother blocks with row-sum-consistent "
                         "pivots; the outer loop runs in defect-correction "
                         "form (solver.cycle_step)")
    ap.add_argument("--ns-pre", type=int, default=None,
                    help="smoothing schedule override (reference: 3)")
    ap.add_argument("--ns-post", type=int, default=None)
    ap.add_argument("--coarsest", default="direct")
    ap.add_argument("--tridiag", default="thomas",
                    choices=["thomas", "pcr"])
    ap.add_argument("--refine", action="store_true",
                    help="mixed-precision defect correction to 1e-12")
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()
    if args.refine:
        row = run_refine(args.case, args.nx, args.ny, args.nz,
                         compact=not args.no_compact,
                         coarsest=args.coarsest)
    else:
        row = run_case(args.case, args.nx, args.ny, args.nz,
                       dtype=args.dtype, reps=args.reps,
                       compact=not args.no_compact,
                       kernel=not args.no_kernel,
                       bf16_bands=args.bf16_bands, ns_pre=args.ns_pre,
                       ns_post=args.ns_post, coarsest=args.coarsest,
                       tridiag=args.tridiag)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
