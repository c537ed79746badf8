"""Public API: the nonhydrostatic pressure solver a host ocean model calls.

JAX port of ``src/nhydro.f90`` — the reference's library interface:
  nhydro_init      -> NHModel(...)              (nhydro.f90:18-33)
  nhydro_matrices  -> NHModel.set_matrices(...) (:36-50)
  nhydro_solve     -> NHModel.solve(...)        (:53-102)
  nhydro_check_nondivergence -> NHModel.check_nondivergence(...) (:105-134)
  nhydro_clean     -> (garbage collection; XLA owns memory)

Velocity array layout (z leading; see ops/rhs.py for the mapping to the
reference's (i, j, k) interfaces):
  u: (nz, ny+2, nx+1), v: (nz, ny+1, nx+2), w: (nz+1, ny+2, nx+2)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .assembly import FineMetrics, build_operators
from .bc import extend_h1
from .config import SolverConfig
from .levels import build_level_plan, describe
from .ops.projection import correct_uvw
from .ops.rhs import compute_rhs
from .solver import (SingleDeviceBackend, SolveInfo, build_relax_packs,
                     compact_eligible, solve_p)


class NHModel:
    """Geometric-multigrid solver for the nonhydrostatic pressure Poisson
    equation on a terrain-following ocean grid."""

    def __init__(self, nx: int, ny: int, nz: int,
                 cfg: Optional[SolverConfig] = None, verbose: bool = False):
        self.cfg = cfg or SolverConfig()
        self.levels = build_level_plan(nx, ny, nz,
                                       aggressive=self.cfg.aggressive)
        self.nx, self.ny, self.nz = nx, ny, nz
        self.backend = None
        self.metrics: Optional[FineMetrics] = None
        if verbose:
            print(describe(self.levels))

    @property
    def dtype(self):
        return jnp.dtype(self.cfg.dtype)

    def set_matrices(self, dx, dy, zeta, h, rmask=None,
                     hc: float = 0.0, theta_b: float = 0.0,
                     theta_s: float = 0.0) -> None:
        """Assemble all levels from topography (nhydro_matrices,
        nhydro.f90:36-50).  Inputs are interior (ny, nx) arrays."""
        dt = self.dtype
        conv = lambda a: jnp.asarray(a, dtype=dt)
        if rmask is None:
            rmask = jnp.ones((self.ny, self.nx), dtype=dt)

        # one compiled program for the whole hierarchy: assembly is a few
        # hundred primitives, and eager dispatch of each costs more than
        # the work
        @jax.jit
        def _assemble(dx, dy, zeta, h, rmask):
            return build_operators(self.levels, dx, dy, zeta, h, rmask,
                                   hc, theta_b, theta_s, self.cfg)

        ops, metrics = _assemble(conv(dx), conv(dy), conv(zeta), conv(h),
                                 conv(rmask))
        self.ops = ops
        self.metrics = metrics
        self.backend = SingleDeviceBackend(self.levels, ops, self.cfg)
        # persist the compact-smoother gather packs (pre-sliced aligned
        # blocks + factored Thomas pivots) for the levels that will smooth
        # in quad-parity form — one jitted pass, reused by every sweep
        elig = [compact_eligible(s, self.cfg) for s in self.levels]
        if any(elig):
            packs = jax.jit(lambda o: build_relax_packs(
                self.levels, o, self.cfg, elig))(ops)
            self.backend.packs = list(packs)
        self._packs = self.backend.packs
        if self.cfg.netcdf_output:
            # stage dumps: metrics + per-level operator (the reference
            # writes these inside define_matrices when netcdf_output —
            # mg_define_matrix.f90:187-194 and :668-673; iter = 1-based lev)
            self._dump(metrics.dx, "dx", "dx.nc", 1)
            self._dump(metrics.dy, "dy", "dy.nc", 1)
            self._dump(metrics.zr, "zr", "zr.nc", 1)
            self._dump(metrics.zw, "zw", "zw.nc", 1)
            for lev, op in enumerate(ops):
                self._dump(op.cA, "ca", "cA.nc", lev + 1)

    def _dump(self, arr, vname: str, fname: str, iteration=None) -> None:
        """Diagnostics field dump (gated by ``cfg.netcdf_output``)."""
        if not self.cfg.netcdf_output:
            return
        import os
        from .io.diagnostics import write_field
        write_field(arr, vname, os.path.join(self.cfg.output_dir, fname),
                    rank=0, iteration=iteration)

    def distribute(self, npx: int, npy: int, devices=None,
                   comm: str = "auto") -> None:
        """Distribute the solve over an (npx, npy) device mesh — the
        reference's 2-D horizontal domain decomposition
        (npxg x npyg, nhydro_init args, nhydro.f90:18).  Call after
        :meth:`set_matrices`.

        ``comm`` selects the communication layer:
          - 'auto' (default): 'shard_map' whenever any sharded level can
            smooth compact/quad-persistent there (so the flagship
            distributed configuration keeps the fast smoother paths —
            testcuc runs 1024^2 on 2x2, mg_testcuc.f90:34-39), else
            'gspmd'.
          - 'gspmd': global arrays + sharding constraints; XLA inserts the
            halo collectives, operators replicated.
          - 'shard_map': explicit two-phase ppermute halo exchange with
            per-shard-extended operator storage (the reference's MPI
            protocol made explicit; parallel/shardmap_backend.py).

        Distributes the FULL nhydro_solve: besides the pressure cycles,
        rhs/project/check_nondivergence run on per-shard staggered velocity
        tiles with per-shard wall-flux masks (parallel/physics.py — the
        reference's distributed compute_rhs/correct_uvw contract).
        """
        from .parallel import (DistributedBackend, DistributedPhysics,
                               MeshPlan, ShardMapBackend, make_mesh,
                               shard_operators, shard_operators_blocked)
        assert self.backend is not None, "call set_matrices first"
        mesh = make_mesh(npx, npy, devices)
        plan = MeshPlan.create(mesh, self.levels, nsmall=self.cfg.nsmall)
        if comm == "auto":
            from .parallel.shardmap_backend import default_comm
            comm = default_comm(self.levels, plan, self.cfg)
        # replicated (agglomerated) levels keep their persisted compact
        # packs, pinned replicated on the mesh; sharded levels smooth
        # through the shard_map/GSPMD paths (per-shard pack build there)
        from jax.sharding import NamedSharding, PartitionSpec as P
        repl = NamedSharding(mesh, P())
        packs = [None if (pk is None or plan.shards[lev].sharded)
                 else jax.device_put(pk, repl)
                 for lev, pk in enumerate(getattr(self, "_packs",
                                                  [None] * len(self.levels)))]
        if comm == "shard_map":
            ops = shard_operators_blocked(self.ops, plan)
            self.backend = ShardMapBackend(self.levels, ops, self.cfg, plan,
                                           packs=packs)
            # sharded compact levels persist PER-SHARD packs (built inside
            # shard_map from the blocked cA: each device keeps its tile's
            # gather blocks + factored pivots)
            from .parallel.shardmap_backend import shard_packs_blocked
            spk = shard_packs_blocked(self.levels, ops, self.cfg, plan,
                                      self.backend)
            self.backend.packs = [s if s is not None else packs[lev]
                                  for lev, s in enumerate(spk)]
        elif comm == "gspmd":
            ops = shard_operators(self.ops, plan)
            self.backend = DistributedBackend(self.levels, ops, self.cfg,
                                              plan, packs=packs)
        else:
            raise ValueError(f"unknown comm layer {comm!r}")
        self._physics = DistributedPhysics(plan, self._metrics_live(),
                                           self.cfg)

    def _metrics_live(self) -> FineMetrics:
        assert self.metrics is not None, "call set_matrices first"
        return self.metrics

    # -- pieces (also exposed for tests/benchmarks) ------------------------
    def rhs(self, u, v, w) -> jnp.ndarray:
        if getattr(self, "_physics", None) is not None:
            return self._physics.rhs(u, v, w)
        mt = self._metrics_live()
        if not hasattr(self, "_rhs_jit"):
            self._rhs_jit = jax.jit(
                lambda mt, u, v, w: compute_rhs(mt, u, v, w, self.cfg.bmask))
        return self._rhs_jit(mt, u, v, w)

    def pressure_solve(self, b, tol=None, maxiter=None, verbose=False
                       ) -> Tuple[jnp.ndarray, SolveInfo]:
        return solve_p(self.backend, b, self.cfg, tol=tol, maxiter=maxiter,
                       verbose=verbose)

    def project(self, p, u, v, w):
        if getattr(self, "_physics", None) is not None:
            return self._physics.project(p, u, v, w)
        mt = self._metrics_live()
        if not hasattr(self, "_proj_jit"):
            self._proj_jit = jax.jit(
                lambda mt, p, u, v, w: correct_uvw(mt, extend_h1(p), u, v, w))
        return self._proj_jit(mt, p, u, v, w)

    # -- the reference's three-step solve (nhydro.f90:80-98) ---------------
    def solve(self, u, v, w, tol=None, maxiter=None, verbose=False):
        """compute_rhs -> solve_p -> correct_uvw.  Returns corrected
        (u, v, w), the pressure p, and a SolveInfo."""
        u = jnp.asarray(u, dtype=self.dtype)
        v = jnp.asarray(v, dtype=self.dtype)
        w = jnp.asarray(w, dtype=self.dtype)
        b = self.rhs(u, v, w)
        self._dump(b, "b", "b.nc", 1)              # nhydro.f90:85-87
        # (p_end/r_end are dumped by solve_p itself, nhydro.f90:92-95)
        p, info = self.pressure_solve(b, tol=tol, maxiter=maxiter,
                                      verbose=verbose)
        u, v, w = self.project(p, u, v, w)
        return u, v, w, p, info

    def check_nondivergence(self, u, v, w) -> jnp.ndarray:
        """Recompute the divergence of corrected velocities; should be at
        machine zero (nhydro_check_nondivergence, nhydro.f90:105-134).
        Returns max |div|."""
        if getattr(self, "_physics", None) is not None:
            return self._physics.check_nondivergence(u, v, w)
        mt = self._metrics_live()
        if self.cfg.netcdf_output:                 # nhydro.f90:130-132
            div = self.rhs(u, v, w)
            self._dump(div, "b", "check.nc", 1)
            return jnp.max(jnp.abs(div))
        if not hasattr(self, "_check_jit"):
            self._check_jit = jax.jit(
                lambda mt, u, v, w: jnp.max(jnp.abs(
                    compute_rhs(mt, u, v, w, self.cfg.bmask))))
        return self._check_jit(mt, u, v, w)
