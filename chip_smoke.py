"""Smoke test of the multigrid solve on one NVIDIA GPU.

Drives the solver through the entry points a host model calls
(``NHModel`` -> ``set_matrices`` -> ``solve`` -> ``check_nondivergence``)
in one process, at the reference's own grids, and checks every result:

  1. the card: ``nvidia-smi`` name and power limit, ``jax.devices()``;
  2. seamount 64^3 in float64 against the CPU golden history
     (tests/goldens/seamount64_history.json);
  3. the Pallas color-update kernel against the XLA compact smoother at
     CUC level-0 width (nz=64, 512x512 quads), both ``cmatrix`` values
     and the bfloat16 blocks of perf mode, plus one sweep's time each way;
  4. CUC 1024^2 x 64 in float32 (synthetic slope), default configuration,
     with the kernel and without it: f32 floor within 10 F-cycles,
     matching histories, divergence, ms per F-cycle, memory analysis;
  5. seamount 64^3 in float32: the same solve and numbers.

``--four`` runs only the 2x2 ``shard_map`` CUC solve on four cards
against the single-card solve in the same process (one process drives
all four cards).

Exits non-zero without a result line when JAX finds no GPU.  The last
line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

    python chip_smoke.py            # one card
    python chip_smoke.py --four     # four cards
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from mgroms_jax.platform import card_info, enable_compile_cache, require_gpu

HERE = os.path.dirname(os.path.abspath(__file__))

# CUC 1024^2 x 64: the reference's testcuc grid (mg_testcuc.f90:34-39)
CUC = (1024, 1024, 64)
SEAMOUNT = (64, 64, 64)


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"{msg}  [{time.perf_counter() - T0:.0f} s]", flush=True)


def card() -> str:
    info = card_info()
    if info is None:
        raise RuntimeError("nvidia-smi gave no card name and power limit")
    return info


def build(case_name: str, grid, cfg):
    """NHModel with matrices set for ``case_name`` at ``grid``."""
    from mgroms_jax import NHModel
    nx, ny, nz = grid
    dt = jnp.dtype(cfg.dtype)
    if case_name == "cuc":
        from mgroms_jax.cases.cuc import setup_cuc_synthetic
        c = setup_cuc_synthetic(nx, ny, nz, dtype=dt)
    else:
        from mgroms_jax.cases.seamount import setup_seamount
        c = setup_seamount(nx, ny, nz, dtype=dt)
    m = NHModel(nx, ny, nz, cfg=cfg)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


def velocities(grid, dtype):
    from mgroms_jax.cases.seamount import initial_velocities
    nx, ny, nz = grid
    return initial_velocities(nx, ny, nz, dtype=jnp.dtype(dtype))


def fcycle_ms(be, b, cfg, iters: int = 5, analyse: bool = False) -> float:
    """ms per F-cycle (solver.solve_step: one F-cycle + fresh residual +
    norm, the solve's own compiled program) in steady state: warm-up, then
    ``iters`` calls and one block_until_ready (utils/timing)."""
    from mgroms_jax.solver import solve_init, solve_step
    from mgroms_jax.utils.timing import time_device_fn
    p, bs, r, _, _ = solve_init(be, b)
    if analyse:
        ma = solve_step.lower(be, p, bs, r, cfg).compile().memory_analysis()
        log(f"    memory_analysis(F-cycle step): {ma}")

    def step(c, be, bs):
        p, r, _ = solve_step(be, c[0], bs, c[1], cfg)
        return p, r

    return 1e3 * time_device_fn(step, (p, r), iters=iters, args=(be, bs),
                                jit=False)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    log(f"    ok: {what}")


def phase_seamount_f64() -> None:
    """Whole solver at the reference's precision against the CPU golden."""
    from mgroms_jax import SolverConfig
    log("[2] seamount 64^3 float64 vs tests/goldens/seamount64_history.json")
    with open(os.path.join(HERE, "tests", "goldens",
                           "seamount64_history.json")) as f:
        gold = json.load(f)
    m = build("seamount", tuple(gold["grid"]), SolverConfig())
    u, v, w = velocities(gold["grid"], "float64")
    uc, vc, wc, p, info = m.solve(u, v, w, tol=1e-12, maxiter=30)
    log(f"    niter={info.niter} res={info.res:.3e} "
        f"history={[f'{h:.6e}' for h in info.history]}")
    check(info.niter == gold["niter"], f"niter {info.niter} == golden "
          f"{gold['niter']}")
    check(info.res <= 1e-12, f"final residual {info.res:.3e} <= 1e-12")
    # GPU reductions sum in another order than the CPU: each history entry
    # carries roundoff of ~1e-16 of ||b|| per cycle, amplified through the
    # cycle's operators; 1e-4 relative (plus 1e-15 absolute) bounds it with
    # room, and is 7 orders tighter than the cycle-to-cycle change
    rel = [abs(h - g) / max(g, 1e-15)
           for h, g in zip(info.history, gold["history"])]
    log(f"    max rel history deviation {max(rel):.3e}")
    check(all(abs(h - g) <= 1e-4 * g + 1e-15
              for h, g in zip(info.history, gold["history"])),
          "history within rtol 1e-4 (+1e-15 abs) of the golden")
    div = float(m.check_nondivergence(uc, vc, wc))
    log(f"    check_nondivergence max|div| = {div:.3e}")


def _random_pack_problem(grid, real: bool, seed: int = 0):
    """Synthetic diagonally dominant 8-band operator + state at ``grid``
    (the kernel is a linear pass: any band data pins the arithmetic)."""
    from mgroms_jax.ops.relax_compact import build_compact_pack, split_quads
    nx, ny, nz = grid
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    cA = jax.random.uniform(ks[0], (8, nz, ny + 2, nx + 2), jnp.float32,
                            -0.1, 0.1).at[0].add(-4.0)
    pack = jax.jit(build_compact_pack, static_argnums=1)(cA, real)
    del cA
    p = jax.random.normal(ks[1], (nz, ny, nx), jnp.float32)
    b = jax.random.normal(ks[2], (nz, ny, nx), jnp.float32)
    return pack, split_quads(p), split_quads(b)


def phase_kernel() -> dict:
    """Kernel vs the XLA compact smoother at CUC level-0 width."""
    from mgroms_jax.ops.pallas.relax_tiled import (
        relax_compact_tiled_quads, relax_residual_tiled_quads)
    from mgroms_jax.ops.relax_compact import (
        _TKEYS, attach_lp, relax_compact_quads, relax_residual_compact_quads)
    from mgroms_jax import SolverConfig
    from mgroms_jax.utils.timing import time_device_fn
    log("[3] color-update kernel vs XLA at CUC level 0 "
        "(nz=64, 512x512 quads)")
    interp = SolverConfig(dtype="float32").pallas_interpret
    times = {}
    for real in (True, False):
        pack, q0, bq = _random_pack_problem(CUC, real)
        sweep_k = jax.jit(lambda q, bq, pk: relax_compact_tiled_quads(
            q, bq, pk, 1, "RB", real, interpret=interp))
        sweep_x = jax.jit(lambda q, bq, pk: relax_compact_quads(
            q, bq, pk, 1, "RB", real))
        qk, qx = sweep_k(q0, bq, pack), sweep_x(q0, bq, pack)
        scale = max(float(jnp.max(jnp.abs(qx[t]))) for t in _TKEYS)
        err = max(float(jnp.max(jnp.abs(qk[t] - qx[t]))) for t in _TKEYS)
        # float32 with FMA contraction chosen independently by Triton and
        # XLA: each plane's 16-term gather and the 64-plane substitution
        # differ by a few ulp per step; 2e-5 of max|x| (~170 ulp) bounds
        # the accumulation with room
        log(f"    cmatrix={'real' if real else 'simple'}: sweep "
            f"max|err|/max|x| = {err / scale:.3e}")
        check(err <= 2e-5 * scale, "kernel sweep within 2e-5 of max|x|")
        fk = jax.jit(lambda q, bq, pk: relax_residual_tiled_quads(
            q, bq, pk, 1, real, interpret=interp))
        fx = jax.jit(lambda q, bq, pk: relax_residual_compact_quads(
            q, bq, pk, 1, real))
        (qk, rk), (qx, rx) = fk(q0, bq, pack), fx(q0, bq, pack)
        rscale = max(float(jnp.max(jnp.abs(rx[t]))) for t in _TKEYS)
        rerr = max(float(jnp.max(jnp.abs(rk[t] - rx[t]))) for t in _TKEYS)
        log(f"    emitting variant: residual max|err|/max|r| = "
            f"{rerr / rscale:.3e}")
        # the residual b - A x cancels to ~1/|A| of |b|, so its relative
        # error is the state's error times the operator's scale: 1e-3
        check(rerr <= 1e-3 * rscale,
              "emitted residual within 1e-3 of max|r|")
        if real:
            # perf mode (cfg.fused_bands_bf16): bfloat16 gather blocks with
            # consistent pivots, widened to float32 on load by both paths,
            # so the float32 bound holds
            packl = jax.jit(attach_lp)(pack)
            ql, qlx = sweep_k(q0, bq, packl), sweep_x(q0, bq, packl)
            lscale = max(float(jnp.max(jnp.abs(qlx[t]))) for t in _TKEYS)
            lerr = max(float(jnp.max(jnp.abs(ql[t] - qlx[t])))
                       for t in _TKEYS)
            log(f"    bf16 blocks (pack.lp): sweep max|err|/max|x| = "
                f"{lerr / lscale:.3e}")
            check(lerr <= 2e-5 * lscale,
                  "kernel sweep with bf16 blocks within 2e-5 of max|x|")
            del packl, ql, qlx
        name = "real" if real else "simple"
        for label, f in (("kernel", sweep_k), ("xla", sweep_x)):
            t = time_device_fn(f, q0, iters=5, args=(bq, pack), jit=False)
            times[f"{name}_{label}"] = 1e3 * t
            log(f"    one RB sweep ({name}, {label}): {1e3 * t:.3f} ms")
        del pack, q0, bq, qk, qx, rk, rx
    return times


def _divergence_ratio(m, uc, vc, wc, b0):
    """max|div| over the interior (two cells from every wall) over
    max|b|: the boundary ring keeps the discretization's O(0.3%) remnant
    (the reference behaves the same), the interior is the solve's."""
    div = m.rhs(uc, vc, wc)
    inner = div[2:-2, 2:-2, 2:-2]
    return float(jnp.max(jnp.abs(inner)) / jnp.max(jnp.abs(b0)))


def phase_f32(case_name: str, grid, label: str) -> dict:
    """float32 solve with the kernel, then the same operators without it:
    floor within 10 F-cycles, matching histories, divergence, ms/F-cycle."""
    import dataclasses
    from mgroms_jax import SolverConfig
    from mgroms_jax.solver import SingleDeviceBackend, solve_p
    log(f"[{label}] {case_name} {grid[2]}x{grid[1]}x{grid[0]} "
        "(nz x ny x nx) float32, default configuration")
    cfg = SolverConfig(dtype="float32")
    t0 = time.perf_counter()
    m = build(case_name, grid, cfg)
    u, v, w = velocities(grid, "float32")
    b0 = m.rhs(u, v, w)
    jax.block_until_ready(b0)
    log(f"    set-up {time.perf_counter() - t0:.1f} s")
    uc, vc, wc, p, info = m.solve(u, v, w, tol=1e-4, maxiter=10)
    log(f"    kernel on:  niter={info.niter} res={info.res:.3e} "
        f"history={[f'{h:.4e}' for h in info.history]}")
    check(info.res <= 1e-4 and info.niter <= 10,
          "f32 floor (1e-4) within 10 F-cycles")
    ratio = _divergence_ratio(m, uc, vc, wc, b0)
    log(f"    interior max|div|/max|b| = {ratio:.3e}")
    # the divergence is the residual of the solved system: at a 1e-4
    # relative residual its interior maximum stays well inside 1e-2
    check(ratio <= 1e-2, "interior divergence at the f32 level (<= 1e-2)")
    del uc, vc, wc, p
    cfg_off = dataclasses.replace(cfg, pallas_kernel=False)
    be_off = SingleDeviceBackend(m.levels, m.ops, cfg_off,
                                 packs=m.backend.packs)
    _, info_off = solve_p(be_off, b0, cfg_off, tol=1e-4, maxiter=10)
    log(f"    kernel off: niter={info_off.niter} res={info_off.res:.3e} "
        f"history={[f'{h:.4e}' for h in info_off.history]}")
    dev = max(abs(a - c) / c for a, c in zip(info.history,
                                             info_off.history))
    log(f"    max per-cycle relative history deviation {dev:.3e}")
    # two float32 solves that differ only in FMA contraction and summation
    # order: each cycle's residual norm agrees to a few per cent above the
    # f32 floor, where roundoff is still small against the residual
    check(info.niter == info_off.niter and dev <= 0.05,
          "kernel and XLA histories agree per cycle within 5%")
    out = {"niter": info.niter, "res": info.res,
           "history": list(info.history), "interior_div_rel": ratio}
    out["fcycle_ms_kernel"] = fcycle_ms(m.backend, b0, cfg, analyse=True)
    out["fcycle_ms_xla"] = fcycle_ms(be_off, b0, cfg_off)
    for k in ("fcycle_ms_kernel", "fcycle_ms_xla"):
        log(f"    {k} = {out[k]:.3f}")
    return out


def phase_four() -> dict:
    """2x2 shard_map CUC solve on four cards vs the single-card solve.

    The two solves run in two threads, so that their programs (minutes of
    compilation each at this size) compile at the same time."""
    from concurrent.futures import ThreadPoolExecutor
    from mgroms_jax import SolverConfig
    log("[6] CUC 1024^2 x 64 float32 on 2x2 shard_map vs one card")
    check(len(jax.devices()) >= 4, "four GPUs visible")
    cfg = SolverConfig(dtype="float32")
    m1 = build("cuc", CUC, cfg)
    m4 = build("cuc", CUC, cfg)
    m4.distribute(2, 2, comm="shard_map")
    u, v, w = velocities(CUC, "float32")
    b0 = m1.rhs(u, v, w)
    log("    set-up done; solving on one card and on 2x2 cards")
    with ThreadPoolExecutor(2) as ex:
        f1 = ex.submit(m1.pressure_solve, b0, tol=1e-4, maxiter=10)
        f4 = ex.submit(m4.pressure_solve, b0, tol=1e-4, maxiter=10)
        (p1, info1), (p4, info4) = f1.result(), f4.result()
    p1 = np.asarray(p1)
    log(f"    one card:  niter={info1.niter} "
        f"history={[f'{h:.4e}' for h in info1.history]}")
    log(f"    2x2 cards: niter={info4.niter} "
        f"history={[f'{h:.4e}' for h in info4.history]}")
    dev = max(abs(a - c) / c for a, c in zip(info4.history,
                                             info1.history))
    perr = float(np.max(np.abs(np.asarray(p4) - p1)) / np.max(np.abs(p1)))
    log(f"    max per-cycle history deviation {dev:.3e}; "
        f"max|p4 - p1|/max|p1| = {perr:.3e}")
    # the distributed solve runs the same cycle with halos from ppermute:
    # the iterates differ only by float32 summation order, bounded like
    # the kernel-vs-XLA comparison above; p agrees to the f32 floor
    check(info4.niter == info1.niter and dev <= 0.05,
          "2x2 history agrees per cycle within 5%")
    check(perr <= 1e-3, "2x2 pressure within 1e-3 of max|p|")
    ms = fcycle_ms(m4.backend, b0, cfg)
    log(f"    2x2 fcycle_ms = {ms:.3f}")
    return {"niter": info4.niter, "history_dev": dev, "p_rel_err": perr,
            "fcycle_ms_2x2": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 2x2 shard_map CUC solve on four "
                         "cards against the single-card solve")
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this file")
    args = ap.parse_args()

    dev = require_gpu()
    cache = enable_compile_cache()
    jax.config.update("jax_enable_x64", True)   # the f64 golden phase
    log(f"[1] card: {card()}")
    log(f"    jax.devices(): {jax.devices()}")
    log(f"    compile cache: {cache}")
    results = {"card": card(), "device_kind": dev.device_kind}
    t0 = time.perf_counter()
    if args.four:
        results["four"] = phase_four()
    else:
        phase_seamount_f64()
        results["kernel_sweep_ms"] = phase_kernel()
        results["cuc"] = phase_f32("cuc", CUC, "4")
        results["seamount64_f32"] = phase_f32("seamount", SEAMOUNT, "5")
    results["seconds"] = time.perf_counter() - t0
    log(f"results: {json.dumps(results)}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    log(f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
