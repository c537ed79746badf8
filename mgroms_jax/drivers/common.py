"""Shared driver scaffolding (the reference drivers are diff-identical
apart from the case setup — mg_testseamount.f90 / mg_testrndtopo.f90)."""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


def base_parser(nx=64, ny=64, nz=64) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=nx)
    p.add_argument("--ny", type=int, default=ny)
    p.add_argument("--nz", type=int, default=nz)
    p.add_argument("--npx", type=int, default=1,
                   help="device-mesh extent in x (reference npxg)")
    p.add_argument("--npy", type=int, default=1)
    p.add_argument("--comm", default="auto",
                   choices=["auto", "gspmd", "shard_map"],
                   help="distributed communication layer (auto: shard_map "
                        "when the sharded compact smoother is eligible)")
    p.add_argument("--namelist", default="nh_namelist",
                   help="Fortran-namelist config file (defaults used if absent)")
    p.add_argument("--dtype", default=None,
                   help="override dtype (float64 on the CPU, float32 on "
                        "an accelerator)")
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--maxiter", type=int, default=None)
    p.add_argument("--history", default="residual_history.txt",
                   help="residual-history file (reference fort.100)")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")
    p.add_argument("--profile", action="store_true",
                   help="after the solve, profile one F-cycle per level/"
                        "section and print the reference-style table "
                        "(print_tictoc, mg_tictoc.f90:114-153)")
    return p


def run_case(args, case, nit: int = 1):
    """Initialise, assemble, solve, check — the body every reference driver
    shares (mg_testseamount.f90:64-204)."""
    from .. import NHModel, read_namelist
    from ..cases.seamount import initial_velocities
    from ..config import SolverConfig
    from ..platform import default_dtype, enable_compile_cache, is_host
    from ..utils import tictoc

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    platform = jax.devices()[0].platform
    dtype = args.dtype or default_dtype(platform)
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    cfg = read_namelist(args.namelist, base=SolverConfig(dtype=dtype))
    print("Initialise nhydro grids")
    m = NHModel(args.nx, args.ny, args.nz, cfg=cfg, verbose=True)
    tictoc.tic(0, "matrices")
    m.set_matrices(case.dx, case.dy, case.zeta, case.h, hc=case.hc,
                   theta_b=case.theta_b, theta_s=case.theta_s)
    jax.block_until_ready(m.ops[0].cA)
    tictoc.toc(0, "matrices")
    if args.npx * args.npy > 1:
        m.distribute(args.npx, args.npy, comm=getattr(args, "comm", "auto"))

    print("Initialise u, v, w  (U=0, V=0, W=-1 except at bottom)")
    u, v, w = initial_velocities(args.nx, args.ny, args.nz,
                                 dtype=jnp.dtype(dtype))
    for it in range(nit):
        print("Call nhydro solver")
        tictoc.tic(0, "solve")
        uc, vc, wc, p, info = m.solve(u, v, w, tol=args.tol,
                                      maxiter=args.maxiter, verbose=True)
        tictoc.toc(0, "solve")
        print(f"--- summary ---")
        print(f"time spent to solve : {info.time_s:8.3f} s")
        print(f"rescaled performance: {info.rescaled_perf:10.3e}")
        print(f"---------------")
        with open(args.history, "w") as f:
            for i, r in enumerate(info.history):
                f.write(f"{r:.16e} {i}\n")
        print("Check nondivergence")
        div = float(m.check_nondivergence(uc, vc, wc))
        b0 = float(jnp.max(jnp.abs(m.rhs(u, v, w))))
        print(f"max |div| after correction: {div:.3e} (initial {b0:.3e})")
    if getattr(args, "profile", False):
        # per-(level, section) breakdown of one F-cycle — the reference's
        # per-level table (tic/toc inside Fcycle/Vcycle, mg_relax.f90:128+,
        # mg_solvers.f90:45+).  Steady-state re-timing on accelerators,
        # where one eager call is mostly dispatch and compile.
        print("Profiling one F-cycle per level/section ...")
        tictoc.profile_fcycle(m.backend, m.rhs(u, v, w), m.cfg,
                              device_timer=not is_host(platform))
    tictoc.print_tictoc()
    return m, info
