"""Weak/strong scaling harness.

Equivalent of the reference's cluster experiment scripts
(``examples/perf_caparmor/nh_perf_1.sh`` / ``nh_perf_2.sh``: sweeps
npx=npy in {2,4,8,16} x nxg=nyg in {256,512,1024,2048}, nzg=128).

On a single host this runs over a virtual CPU mesh (set
``--simulate N``); on a GPU host it uses the attached cards.  Reports
per-F-cycle time and scaling efficiency vs the smallest mesh.

    python examples/scaling.py --grids 256,512 --meshes 1x1,2x2,4x2 --nz 64
"""

import argparse
import os
import sys
import time

# runnable as `python examples/scaling.py` (script dir shadows the repo
# root on sys.path)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def run_one(nxg, nyg, nz, npx, npy, dtype, comm="auto"):
    import jax.numpy as jnp
    from mgroms_jax import NHModel, SolverConfig
    from mgroms_jax.cases.seamount import initial_velocities, setup_seamount
    from mgroms_jax.solver import cycle_step

    cfg = SolverConfig(dtype=dtype, coarsest="direct")
    m = NHModel(nxg, nyg, nz, cfg=cfg)
    c = setup_seamount(nxg, nyg, nz, dtype=jnp.dtype(dtype))
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    if npx * npy > 1:
        m.distribute(npx, npy, comm=comm)
    be = m.backend
    u, v, w = initial_velocities(nxg, nyg, nz, dtype=jnp.dtype(dtype))
    b = m.rhs(u, v, w)

    @jax.jit
    def step(be, p, b, r):
        p, r = cycle_step(be, p, b, r, cfg)
        return p, r

    @jax.jit
    def init(be, b):
        p = be.zeros(0)
        return p, be.residual(0, p, b)

    p, r = init(be, b)
    p, r = step(be, p, b, r)
    jax.block_until_ready(p)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        p, r = step(be, p, b, r)
    jax.block_until_ready(p)
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grids", default="128,256")
    ap.add_argument("--meshes", default="1x1,2x2")
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--simulate", type=int, default=0,
                    help="force N virtual CPU devices")
    ap.add_argument("--comm", default="auto",
                    choices=["auto", "gspmd", "shard_map"],
                    help="communication layer (model.distribute)")
    args = ap.parse_args()

    if args.simulate:
        import os
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device_count={args.simulate}")
        jax.config.update("jax_platforms", "cpu")
    from mgroms_jax.platform import default_dtype, is_host
    platform = jax.devices()[0].platform
    dtype = args.dtype or default_dtype(platform)
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    grids = [int(g) for g in args.grids.split(",")]
    meshes = [tuple(int(v) for v in mm.split("x"))
              for mm in args.meshes.split(",")]
    # On a VIRTUAL mesh (N simulated devices sharing one host) there is no
    # real speedup to measure: ideal scaling is FLAT wall-clock (same total
    # work, same silicon), so the meaningful column is the overhead factor
    # t_mesh / t_base (communication + partitioning cost; 1.00 = free).
    # On real hardware the classic parallel efficiency applies.
    virtual = is_host(platform)
    effcol = "ovh" if virtual else "eff"
    print(f"platform={platform} dtype={dtype} nz={args.nz} comm={args.comm}"
          f"{' (virtual mesh: ovh = t/t_base, ideal 1.00)' if virtual else ''}")
    print(f"{'grid':>6} {'mesh':>6} {'t/Fcycle':>10} {'Mdof/s':>8} "
          f"{effcol:>6}")
    for g in grids:
        tbase = None
        for npx, npy in meshes:
            if len(jax.devices()) < npx * npy or g % npx or g % npy:
                continue
            t = run_one(g, g, args.nz, npx, npy, dtype, comm=args.comm)
            dofs = g * g * args.nz / t / 1e6
            n = npx * npy
            if tbase is None:
                tbase, nbase = t, n
                eff = 1.0
            elif virtual:
                eff = t / tbase
            else:
                eff = (tbase / t) * (nbase / n)
            print(f"{g:6d} {npx}x{npy:<4d} {t:10.4f} {dofs:8.1f} {eff:6.2f}")


if __name__ == "__main__":
    main()
