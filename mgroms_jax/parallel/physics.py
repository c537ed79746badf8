"""Distributed physics coupling: RHS, projection, nondivergence check.

The reference's ``nhydro_solve`` is distributed end-to-end: compute_rhs and
correct_uvw run on per-rank staggered velocity tiles with halo exchange and
``lbc_null`` wall-flux Dirichlet folded into the fill
(mg_compute_rhs.f90:170-172,291-293; mg_mpi_exchange.f90:952-1013).  This
module is the image of that contract: velocities and fine-level metrics
live in blocked per-shard layouts (each device stores its staggered tile,
overlaps included — exchange.block_overlapped), and the flux/projection
kernels run unchanged inside ``shard_map`` with per-shard face masks built
from the mesh position (exchange.shard_face_masks).

Because every shard computes the same arithmetic the global functions
compute on the same values (overlap columns/rows are consistent duplicates),
the distributed RHS/projection equal their single-device counterparts to
the last ulp — asserted by tests/test_distributed.py.

Staggered overlap table (z leading; see ops/rhs.py layout notes):
  u (nz,   ny+2, nx+1): overlap (2, 1)
  v (nz,   ny+1, nx+2): overlap (1, 2)
  w (nz+1, ny+2, nx+2): overlap (2, 2)
  metrics  (..., ny+2, nx+2): overlap (2, 2)
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..assembly import FineMetrics
from ..config import SolverConfig
from ..ops.projection import correct_uvw
from ..ops.rhs import compute_rhs
from .exchange import (block_overlapped, halo_extend, shard_face_masks,
                       unblock_overlapped)
from .mesh import MeshPlan

_SPEC3 = P(None, "py", "px")

_U_OVL, _V_OVL, _W_OVL, _M_OVL = (2, 1), (1, 2), (2, 2), (2, 2)


def block_metrics(m: FineMetrics, npy: int, npx: int) -> FineMetrics:
    """Fine-level metrics in blocked per-shard (halo-extended tile) form."""
    blk = lambda a: block_overlapped(a, npy, npx, *_M_OVL)
    return FineMetrics(*(blk(f) for f in m))


def block_velocities(u, v, w, npy: int, npx: int):
    return (block_overlapped(u, npy, npx, *_U_OVL),
            block_overlapped(v, npy, npx, *_V_OVL),
            block_overlapped(w, npy, npx, *_W_OVL))


def unblock_velocities(ub, vb, wb, npy: int, npx: int):
    return (unblock_overlapped(ub, npy, npx, *_U_OVL),
            unblock_overlapped(vb, npy, npx, *_V_OVL),
            unblock_overlapped(wb, npy, npx, *_W_OVL))


class DistributedPhysics:
    """Distributed rhs/project/check bound to a mesh plan.

    Built by ``NHModel.distribute``; hosts the blocked metrics (placed
    sharded on the mesh so each device stores only its tile) and the jitted
    shard_map wrappers.
    """

    def __init__(self, plan: MeshPlan, metrics: FineMetrics,
                 cfg: SolverConfig):
        self.plan = plan
        self.cfg = cfg
        npy, npx = plan.mesh.devices.shape
        self.npy, self.npx = npy, npx
        blocked = jax.jit(lambda mm: block_metrics(mm, npy, npx))(metrics)
        # per-field spec: last two dims on the mesh, leading dims unsharded
        self.mspecs = FineMetrics(*(
            P(*([None] * (f.ndim - 2) + ["py", "px"])) for f in blocked))
        self.metrics = FineMetrics(*(
            jax.device_put(f, NamedSharding(plan.mesh, s))
            for f, s in zip(blocked, self.mspecs)))
        self._rhs_jit = None
        self._proj_jit = None

    # -- rhs ---------------------------------------------------------------
    def rhs(self, u, v, w) -> jnp.ndarray:
        """Distributed divergence RHS; returns b sharded P(None,'py','px')."""
        if self._rhs_jit is None:
            mesh, cfg = self.plan.mesh, self.cfg
            npy, npx = self.npy, self.npx

            def local(mt, u_l, v_l, w_l):
                ny_l = u_l.shape[1] - 2
                nx_l = u_l.shape[2] - 1
                um, vm = shard_face_masks(ny_l, nx_l, u_l.dtype)
                return compute_rhs(mt, u_l, v_l, w_l, cfg.bmask,
                                   uface_mask=um, vface_mask=vm)

            smap = jax.shard_map(
                local, mesh=mesh,
                in_specs=(self.mspecs, _SPEC3, _SPEC3, _SPEC3),
                out_specs=_SPEC3)

            @jax.jit
            def run(mt, u, v, w):
                ub, vb, wb = block_velocities(u, v, w, npy, npx)
                return smap(mt, ub, vb, wb)

            self._rhs_jit = run
        return self._rhs_jit(self.metrics, u, v, w)

    # -- projection ----------------------------------------------------------
    def project(self, p, u, v, w) -> Tuple:
        if self._proj_jit is None:
            mesh = self.plan.mesh
            npy, npx = self.npy, self.npx

            def local(mt, p_l, u_l, v_l, w_l):
                return correct_uvw(mt, halo_extend(p_l), u_l, v_l, w_l)

            smap = jax.shard_map(
                local, mesh=mesh,
                in_specs=(self.mspecs, _SPEC3, _SPEC3, _SPEC3, _SPEC3),
                out_specs=(_SPEC3, _SPEC3, _SPEC3))

            @jax.jit
            def run(mt, p, u, v, w):
                ub, vb, wb = block_velocities(u, v, w, npy, npx)
                ub, vb, wb = smap(mt, p, ub, vb, wb)
                return unblock_velocities(ub, vb, wb, npy, npx)

            self._proj_jit = run
        return self._proj_jit(self.metrics, p, u, v, w)

    # -- nondivergence check --------------------------------------------------
    def check_nondivergence(self, u, v, w) -> jnp.ndarray:
        return jnp.max(jnp.abs(self.rhs(u, v, w)))
