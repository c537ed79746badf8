"""Distributed solver backend: the single-device ops under GSPMD.

The cycle math is identical to :class:`mgroms_jax.solver.SingleDeviceBackend`
— this subclass only pins every level's state to its planned distribution
(sharded over the ('py','px') mesh while the tile is big enough, replicated
below the agglomeration threshold).  XLA partitions the stencils/scans and
inserts the halo collective-permutes; the restrict/prolong at the
shard->replicated transition lowers to one small all-gather / local slice,
which is exactly the reference's gather/split pair
(mg_gather.f90:18-220) executed as a single collective.

Because the solve is expressed on *global* arrays, distributed results are
bit-identical to single-device runs (same reduction orders up to XLA's
deterministic partitioning) — the property the reference asserts via its
"small MPI runs on one node" strategy.
"""

from __future__ import annotations

from typing import List

import jax

from ..assembly import LevelOperator
from ..config import SolverConfig
from ..levels import LevelSpec
from ..solver import SingleDeviceBackend
from .mesh import MeshPlan


def shard_operators(ops: List[LevelOperator], plan: MeshPlan
                    ) -> List[LevelOperator]:
    """Place assembled operators on the mesh.

    Operator arrays are halo-extended ((ny+2, nx+2) in the last two dims),
    which does not tile evenly over the mesh, so they are *replicated*;
    XLA slices the local portion of a replicated operand with no
    communication, and the sharded state arrays drive the partitioning of
    every stencil op.  (Memory note: replicating cA costs
    8*nz*(ny+2)*(nx+2) words per device — fine through the CUC scale; the
    per-shard-extended blocked layout that removes this is the explicit
    shard_map backend's job.)
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    repl = NamedSharding(plan.mesh, P())
    out = []
    for op in ops:
        out.append(LevelOperator(
            cA=jax.device_put(op.cA, repl),
            umask=jax.device_put(op.umask, repl),
            vmask=jax.device_put(op.vmask, repl),
            Ainv=None if op.Ainv is None else jax.device_put(op.Ainv, repl),
        ))
    return out


class DistributedBackend(SingleDeviceBackend):
    def __init__(self, levels: List[LevelSpec], ops: List[LevelOperator],
                 cfg: SolverConfig, plan: MeshPlan, platform=None,
                 packs=None):
        super().__init__(levels, ops, cfg, platform=platform, packs=packs)
        self.plan = plan
        self.ndevices = int(plan.mesh.devices.size)

    def tree_flatten(self):
        return ((self.ops, self.packs),
                (self.levels, self.cfg, self.plan, self.platform))

    @classmethod
    def tree_unflatten(cls, aux, children):
        levels, cfg, plan, platform = aux
        return cls(list(levels), list(children[0]), cfg, plan,
                   platform=platform, packs=list(children[1]))

    def _use_compact(self, lev):
        # quad-parity reshape of a py/px-sharded array would force GSPMD
        # resharding; compact form only on replicated (agglomerated) levels
        return (not self.plan.shards[lev].sharded
                and super()._use_compact(lev))

    def _use_kernel(self, lev):
        # a pallas_call on a GSPMD-sharded global array would force a
        # gather; the kernel only on replicated levels here (the
        # shard_map backend runs it on local blocks)
        return (not self.plan.shards[lev].sharded
                and super()._use_kernel(lev))

    def relax(self, lev, p, b, nsweeps):
        p = self.plan.constrain(lev, p)
        return self.plan.constrain(
            lev, super().relax(lev, p, b, nsweeps))

    # fused relax+residual: supports_fused_residual is inherited and is
    # automatically False on sharded levels (state_quads needs
    # _use_compact, which this backend restricts to replicated levels);
    # on replicated levels the single-device orchestration is correct —
    # only the sharding constraints are re-pinned here.
    def relax_residual(self, lev, p, b, nsweeps):
        p = self.plan.constrain(lev, p)
        q, r = super().relax_residual(lev, p, b, nsweeps)
        return self.plan.constrain(lev, q), self.plan.constrain(lev, r)

    def relax_residual_restrict(self, lev, p, b, nsweeps,
                                as_quads: bool = False):
        p = self.plan.constrain(lev, p)
        q, cb = super().relax_residual_restrict(lev, p, b, nsweeps,
                                                as_quads=as_quads)
        return self.plan.constrain(lev, q), self.plan.constrain(lev + 1, cb)

    def residual(self, lev, p, b):
        return self.plan.constrain(lev, super().residual(lev, p, b))

    def restrict(self, lev, r, as_quads: bool = False):
        # the transition level's constraint IS the agglomeration collective
        return self.plan.constrain(
            lev + 1, super().restrict(lev, r, as_quads=as_quads))

    def residual_restrict(self, lev, p, b, as_quads: bool = False):
        return self.plan.constrain(
            lev + 1, super().residual_restrict(lev, p, b,
                                               as_quads=as_quads))

    def prolong(self, lev, pc, as_quads: bool = False):
        return self.plan.constrain(
            lev, super().prolong(lev, pc, as_quads=as_quads))

    def zeros(self, lev, as_quads: bool = False):
        return self.plan.constrain(lev,
                                   super().zeros(lev, as_quads=as_quads))


jax.tree_util.register_pytree_node(
    DistributedBackend,
    DistributedBackend.tree_flatten,
    DistributedBackend.tree_unflatten)
