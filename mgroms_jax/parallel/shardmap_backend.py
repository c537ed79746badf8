"""Explicit shard_map backend: per-shard operators + ppermute halo exchange.

The GSPMD backend (parallel/backend.py) expresses the solve on global
arrays and lets XLA choose the collectives; operators are replicated.  This
backend is the reference's actual distribution contract made explicit
(mg_mpi_exchange.f90 / mg_grids.f90):

  - every sharded level's operator is stored *per-shard extended* — each
    device holds its (8, nz, ny_l+2, nx_l+2) tile, halo ring included, the
    image of the per-rank ``cA(nd,nz,0:ny+1,0:nx+1)`` allocation
    (mg_grids.f90:24-65) — no replication cost;
  - halo refresh is an explicit two-phase ppermute exchange
    (parallel/exchange.py), one per smoother color, exactly the
    fill_halo-per-color protocol (mg_relax.f90:181);
  - the red-black parity is computed from the shard's global origin
    (axis_index * tile), the image of the reference's global (i+j) color
    rule on local loop bounds;
  - levels below the agglomeration threshold stay replicated and run the
    single-device code path (replicate-not-idle, mg_gather.f90).

Iterates are identical to the single-device solver: seam halos carry
neighbour interior values, domain-edge halos the Neumann mirror — the same
extended array extend_h1 builds globally.
"""

from __future__ import annotations

from functools import partial
from typing import List

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..assembly import LevelOperator
from ..config import SolverConfig
from ..levels import LevelSpec, ShardSpec
from ..ops import relax as relax_ops
from ..ops import stencil, transfer
from ..platform import kernel_allowed
from .backend import DistributedBackend
from .exchange import axis_offsets, block_extended, halo_extend
from .mesh import MeshPlan


def compact_shard_eligible(spec: LevelSpec, sh: ShardSpec,
                           cfg: SolverConfig) -> bool:
    """Quad-parity compact smoothing eligibility for a SHARDED level: local
    tiles must be even (so local quad parity == global parity,
    parallel/exchange.extend_quads_shard) — the per-shard image of
    solver.compact_eligible."""
    return (cfg.compact and spec.nd == 8
            and cfg.relax_kind in ("RB", "FC")
            and sh.ny % 2 == 0 and sh.nx % 2 == 0)


def default_comm(levels: List[LevelSpec], plan: MeshPlan,
                 cfg: SolverConfig) -> str:
    """Auto comm-layer selection (model.distribute(comm='auto')): the
    explicit shard_map backend whenever any sharded level can smooth in
    quad-parity compact form there — the configuration where GSPMD would
    forfeit the fast paths (a GSPMD quad split or pallas_call on sharded
    globals forces resharding, parallel/backend.py).  The reference's
    flagship IS such a run (testcuc: 1024^2 on 2x2, mg_testcuc.f90:34-39)."""
    for lev, spec in enumerate(levels):
        sh = plan.shards[lev]
        if sh.sharded and compact_shard_eligible(spec, sh, cfg):
            return "shard_map"
    return "gspmd"


def shard_packs_blocked(levels: List[LevelSpec], ops_blocked, cfg,
                        plan: MeshPlan, backend: "ShardMapBackend") -> list:
    """Per-shard persisted CompactPacks for the SHARDED compact levels.

    The single-device pack (solver.build_relax_packs) covers replicated
    levels; sharded levels build theirs here *inside shard_map* from the
    per-shard-extended blocked cA, so every device persists exactly its
    tile's gather blocks + factored Thomas pivots (the same "operators
    stored per rank" economy as the reference, mg_grids.f90:24-65).
    Returns one pack (a sharded pytree) or None per level."""
    from ..ops.relax_compact import build_compact_pack
    real = cfg.cmatrix == "real"
    packs = []
    for lev, spec in enumerate(levels):
        sh = plan.shards[lev]
        if not (sh.sharded and backend._use_compact_shard(lev)):
            packs.append(None)
            continue
        sp4 = plan.spec(lev, 4)
        out_spec = plan.spec(lev, 3)     # prefix: applies to all pack leaves
        f = jax.shard_map(lambda cA_l: build_compact_pack(cA_l, real),
                          mesh=plan.mesh, in_specs=(sp4,),
                          out_specs=out_spec)
        packs.append(jax.jit(f)(ops_blocked[lev].cA))
    return packs


def shard_operators_blocked(ops: List[LevelOperator], plan: MeshPlan
                            ) -> List[LevelOperator]:
    """Sharded levels: cA in per-shard-extended blocked layout, one tile per
    device (blocked only along the level's ACTIVE mesh axes — staged
    agglomeration).  Replicated levels: unchanged replicated placement."""
    npy, npx = plan.mesh.devices.shape
    repl = NamedSharding(plan.mesh, P())
    out = []
    for lev, op in enumerate(ops):
        sh = plan.shards[lev]
        if sh.sharded:
            bpy = npy if sh.shard_py else 1
            bpx = npx if sh.shard_px else 1
            blk = NamedSharding(plan.mesh, plan.spec(lev, 4))
            cA = jax.device_put(block_extended(op.cA, bpy, bpx), blk)
        else:
            cA = jax.device_put(op.cA, repl)
        out.append(LevelOperator(
            cA=cA,
            umask=jax.device_put(op.umask, repl),
            vmask=jax.device_put(op.vmask, repl),
            Ainv=None if op.Ainv is None else jax.device_put(op.Ainv, repl),
        ))
    return out


class ShardMapBackend(DistributedBackend):
    """Same cycle math, explicit communication."""

    def __init__(self, levels: List[LevelSpec], ops: List[LevelOperator],
                 cfg: SolverConfig, plan: MeshPlan, platform=None,
                 packs=None):
        # skip DistributedBackend.__init__'s assumptions: ops here may
        # already be blocked
        super(DistributedBackend, self).__init__(levels, ops, cfg,
                                                 platform=platform,
                                                 packs=packs)
        self.plan = plan
        self.ndevices = int(plan.mesh.devices.size)

    # -- smoothing ----------------------------------------------------------
    def _use_compact_shard(self, lev) -> bool:
        return compact_shard_eligible(self.levels[lev],
                                      self.plan.shards[lev], self.cfg)

    # -- quad-persistent state on SHARDED levels ----------------------------
    # (state stays as a sharded QuadField between hot ops, so no split/merge
    # per relax call and no interleave in prolong — the single-device
    # quad-persistent V-cycle, extended across the decomposition.)
    def state_quads(self, lev: int) -> bool:
        if lev >= self.nlevs - 1:
            return False
        if not self.plan.shards[lev].sharded:
            return super().state_quads(lev)
        return self._use_compact_shard(lev) and self.packs[lev] is not None

    def to_state(self, lev: int, x):
        from ..ops.relax_compact import QuadField
        if not self.plan.shards[lev].sharded or isinstance(x, QuadField) \
                or not self.state_quads(lev):
            return super().to_state(lev, x)
        sp3 = self.plan.spec(lev, 3)
        f = jax.shard_map(QuadField.split, mesh=self.plan.mesh,
                          in_specs=(sp3,), out_specs=sp3)
        return f(x)

    def to_full(self, lev: int, x):
        from ..ops.relax_compact import QuadField
        if not isinstance(x, QuadField) \
                or not self.plan.shards[lev].sharded:
            return super().to_full(lev, x)
        sp3 = self.plan.spec(lev, 3)
        f = jax.shard_map(lambda q: q.merge(), mesh=self.plan.mesh,
                          in_specs=(sp3,), out_specs=sp3)
        return f(x)

    def _relax_quads_shard(self, lev, p, b, nsweeps):
        """Quad-native smoothing on a sharded level: shard_map over the
        four quad arrays with the ppermute seam exchange per color — the
        fill_halo-per-color protocol (mg_relax.f90:181) on QuadField state."""
        from ..ops.relax_compact import QuadField
        from .exchange import extend_quads_shard
        cfg = self.cfg
        pya, pxa = self._axes(lev)
        sp3 = self.plan.spec(lev, 3)
        use_tiled = self._use_kernel_shard(lev)
        interpret = cfg.pallas_interpret
        real = cfg.cmatrix == "real"

        def local(pq, bq, pack_l):
            ext = lambda q: extend_quads_shard(q, py_axis=pya, px_axis=pxa)
            if use_tiled:
                from ..ops.pallas.relax_tiled import relax_compact_tiled_quads
                out = relax_compact_tiled_quads(
                    pq.asdict(), bq.asdict(), pack_l, nsweeps,
                    cfg.relax_kind, real, interpret=interpret, extend_fn=ext)
            else:
                from ..ops.relax_compact import relax_compact_quads
                out = relax_compact_quads(
                    pq.asdict(), bq.asdict(), pack_l, nsweeps,
                    cfg.relax_kind, real, tridiag_method=cfg.tridiag,
                    extend_fn=ext)
            return QuadField.fromdict(out)

        f = jax.shard_map(local, mesh=self.plan.mesh,
                          in_specs=(sp3, sp3, sp3), out_specs=sp3,
                          check_vma=False)
        return f(p, b, self.packs[lev])

    def supports_fused_residual(self, lev: int) -> bool:
        if not self.plan.shards[lev].sharded:
            # replicated levels use the inherited single-device
            # orchestration (correct there)
            return super().supports_fused_residual(lev)
        # sharded: the orchestration runs inside shard_map with the
        # ppermute seam exchange (the emitted-residual patches are
        # boundary-type agnostic: the one halo-reading row/col per quad
        # is recomputed fresh from the post-sweep extension, which is the
        # right value under both the mirror and the seam exchange)
        return (self.cfg.fused_residual and self.cfg.relax_kind == "RB"
                and self.state_quads(lev))

    def supports_fused_rr(self, lev: int) -> bool:
        shf = self.plan.shards[lev]
        if not shf.sharded:
            return super().supports_fused_rr(lev)
        if lev + 1 >= self.nlevs:
            return False
        shc = self.plan.shards[lev + 1]
        # the local coarse tile must be exactly the local fine tile's
        # children (same active axes, standard 8:1 restriction) — the
        # same condition as the fused residual_restrict below
        return (self.supports_fused_residual(lev)
                and shc.sharded
                and shf.shard_py == shc.shard_py
                and shf.shard_px == shc.shard_px
                and not self.levels[lev + 1].aggressive_from_prev
                and self.levels[lev].nzg % 2 == 0)

    def relax_residual(self, lev, p, b, nsweeps):
        from ..ops.relax_compact import QuadField
        if not self.plan.shards[lev].sharded:
            return super().relax_residual(lev, p, b, nsweeps)
        cfg = self.cfg
        real = cfg.cmatrix == "real"
        interpret = cfg.pallas_interpret
        use_tiled = self._use_kernel_shard(lev)
        pya, pxa = self._axes(lev)
        sp3 = self.plan.spec(lev, 3)

        def local(pq, bq, pack_l):
            from .exchange import extend_quads_shard
            ext = lambda q: extend_quads_shard(q, py_axis=pya, px_axis=pxa)
            if use_tiled:
                from ..ops.pallas.relax_tiled import \
                    relax_residual_tiled_quads
                q, rq = relax_residual_tiled_quads(
                    pq.asdict(), bq.asdict(), pack_l, nsweeps, real,
                    interpret=interpret, extend_fn=ext)
            else:
                from ..ops.relax_compact import relax_residual_compact_quads
                q, rq = relax_residual_compact_quads(
                    pq.asdict(), bq.asdict(), pack_l, nsweeps, real,
                    tridiag_method=cfg.tridiag, extend_fn=ext)
            return QuadField.fromdict(q), QuadField.fromdict(rq)

        f = jax.shard_map(local, mesh=self.plan.mesh,
                          in_specs=(sp3, sp3, sp3), out_specs=(sp3, sp3),
                          check_vma=False)
        return f(p, b, self.packs[lev])

    def relax_residual_restrict(self, lev, p, b, nsweeps,
                                as_quads: bool = False):
        from ..ops.relax_compact import QuadField
        if not self.plan.shards[lev].sharded:
            return super().relax_residual_restrict(lev, p, b, nsweeps,
                                                   as_quads=as_quads)
        cfg = self.cfg
        real = cfg.cmatrix == "real"
        interpret = cfg.pallas_interpret
        use_tiled = self._use_kernel_shard(lev)
        pya, pxa = self._axes(lev)
        sp3 = self.plan.spec(lev, 3)

        def local(pq, bq, pack_l):
            from .exchange import extend_quads_shard
            ext = lambda q: extend_quads_shard(q, py_axis=pya, px_axis=pxa)
            if use_tiled:
                from ..ops.pallas.relax_tiled import \
                    relax_residual_restrict_tiled_quads
                q, full_c = relax_residual_restrict_tiled_quads(
                    pq.asdict(), bq.asdict(), pack_l, nsweeps, real,
                    interpret=interpret, extend_fn=ext)
            else:
                from ..ops.relax_compact import \
                    relax_residual_restrict_compact_quads
                q, full_c = relax_residual_restrict_compact_quads(
                    pq.asdict(), bq.asdict(), pack_l, nsweeps, real,
                    tridiag_method=cfg.tridiag, extend_fn=ext)
            # coarse tiles are even whenever the coarse level is
            # quad-persistent, so the local split IS the global split
            out_c = QuadField.split(full_c) if as_quads else full_c
            return QuadField.fromdict(q), out_c

        f = jax.shard_map(local, mesh=self.plan.mesh,
                          in_specs=(sp3, sp3, sp3),
                          out_specs=(sp3, self.plan.spec(lev + 1, 3)),
                          check_vma=False)
        return f(p, b, self.packs[lev])

    def _axes(self, lev):
        """Active mesh axis names for this level (None = dropped by staged
        agglomeration: physical mirror instead of seam exchange there)."""
        sh = self.plan.shards[lev]
        return ("py" if sh.shard_py else None,
                "px" if sh.shard_px else None)

    def _use_kernel_shard(self, lev) -> bool:
        """The Pallas color-update kernel on a SHARDED level's local blocks
        (the single-device gate's per-shard image; the pallas_call runs
        inside shard_map on each device's tile)."""
        return (self.levels[lev].nd == 8
                and kernel_allowed(self.platform, self.cfg))

    def relax(self, lev, p, b, nsweeps):
        sh = self.plan.shards[lev]
        if not sh.sharded:
            return super().relax(lev, p, b, nsweeps)
        from ..ops.relax_compact import QuadField
        if isinstance(p, QuadField):
            return self._relax_quads_shard(lev, p, b, nsweeps)
        cfg = self.cfg
        use_compact = self._use_compact_shard(lev)
        use_tiled = use_compact and self._use_kernel_shard(lev) \
            and self.packs[lev] is not None
        interpret = cfg.pallas_interpret
        pya, pxa = self._axes(lev)
        sp3, sp4 = self.plan.spec(lev, 3), self.plan.spec(lev, 4)

        def local_tiled(p_l, b_l, pack_l):
            from ..ops.pallas.relax_tiled import relax_compact_tiled
            from .exchange import extend_quads_shard
            return relax_compact_tiled(
                p_l, b_l, pack_l, nsweeps, cfg.relax_kind,
                cfg.cmatrix == "real", interpret=interpret,
                extend_fn=lambda q: extend_quads_shard(
                    q, py_axis=pya, px_axis=pxa))

        def local_compact(p_l, b_l, pack_l):
            from ..ops.relax_compact import relax_compact
            from .exchange import extend_quads_shard
            return relax_compact(
                p_l, b_l, None, nsweeps, cfg.relax_kind,
                cfg.cmatrix == "real", tridiag_method=cfg.tridiag,
                pack=pack_l,
                extend_fn=lambda q: extend_quads_shard(
                    q, py_axis=pya, px_axis=pxa))

        def local(p_l, b_l, cA_l):
            j0, i0 = axis_offsets(sh.ny, sh.nx, pya, pxa)
            return relax_ops.relax(
                p_l, b_l, cA_l, nsweeps, cfg.relax_kind,
                cfg.cmatrix == "real",
                extend_fn=lambda x: halo_extend(x, pya, pxa),
                j0=j0, i0=i0, tridiag_method=cfg.tridiag)

        if use_compact and self.packs[lev] is not None:
            # check_vma=False: pallas_call inside shard_map would need
            # vma-annotated out_shapes otherwise
            f = jax.shard_map(local_tiled if use_tiled else local_compact,
                              mesh=self.plan.mesh,
                              in_specs=(sp3, sp3, sp3), out_specs=sp3,
                              check_vma=False)
            return f(p, b, self.packs[lev])
        if use_compact:
            # no persisted pack (direct backend construction in tests):
            # build it per call from the local band tile
            def local_compact_ca(p_l, b_l, cA_l):
                from ..ops.relax_compact import relax_compact
                from .exchange import extend_quads_shard
                return relax_compact(
                    p_l, b_l, cA_l, nsweeps, cfg.relax_kind,
                    cfg.cmatrix == "real", tridiag_method=cfg.tridiag,
                    extend_fn=lambda q: extend_quads_shard(
                        q, py_axis=pya, px_axis=pxa))
            f = jax.shard_map(local_compact_ca, mesh=self.plan.mesh,
                              in_specs=(sp3, sp3, sp4), out_specs=sp3)
            return f(p, b, self.ops[lev].cA)
        f = jax.shard_map(local, mesh=self.plan.mesh,
                          in_specs=(sp3, sp3, sp4),
                          out_specs=sp3)
        return f(p, b, self.ops[lev].cA)

    # -- residual -------------------------------------------------------------
    def residual(self, lev, p, b):
        from ..ops.relax_compact import QuadField
        if self.plan.shards[lev].sharded and isinstance(p, QuadField):
            return self._residual_quads_shard(lev, p, b)
        if not self.plan.shards[lev].sharded:
            return super().residual(lev, p, b)
        real = self.cfg.cmatrix == "real"
        pya, pxa = self._axes(lev)
        sp3, sp4 = self.plan.spec(lev, 3), self.plan.spec(lev, 4)

        def local(p_l, b_l, cA_l):
            return stencil.residual(halo_extend(p_l, pya, pxa), b_l, cA_l,
                                    real)

        f = jax.shard_map(local, mesh=self.plan.mesh,
                          in_specs=(sp3, sp3, sp4), out_specs=sp3)
        return f(p, b, self.ops[lev].cA)

    def _residual_quads_shard(self, lev, p, b):
        """r = b - A p in quad layout on a sharded level (shard_map over the
        quads with the ppermute seam extension)."""
        from ..ops.relax_compact import QuadField, residual_quads
        from .exchange import extend_quads_shard
        real = self.cfg.cmatrix == "real"
        pya, pxa = self._axes(lev)
        sp3 = self.plan.spec(lev, 3)

        def local(pq, bq, pack_l):
            return QuadField.fromdict(residual_quads(
                pq.asdict(), bq.asdict(), pack_l, real,
                extend_fn=lambda q: extend_quads_shard(
                    q, py_axis=pya, px_axis=pxa)))

        f = jax.shard_map(local, mesh=self.plan.mesh,
                          in_specs=(sp3, sp3, sp3), out_specs=sp3)
        return f(p, b, self.packs[lev])

    def residual_restrict(self, lev, p, b, as_quads: bool = False):
        """Quad-persistent sharded levels keep the residual local in quad
        layout; restrict then carries any aggressive or stage-transition
        resharding exactly like the full-array path."""
        from ..ops.relax_compact import QuadField
        if self.plan.shards[lev].sharded and isinstance(p, QuadField):
            rq = self._residual_quads_shard(lev, p, b)
            return self.restrict(lev, rq, as_quads=as_quads)
        return super().residual_restrict(lev, p, b, as_quads=as_quads)

    # -- transfers ------------------------------------------------------------
    # restrict: the 8-child sum is shard-local (children of a local coarse
    # tile are exactly the local fine tile); the GSPMD reshape-sum inherits
    # the sharding with no communication, and each stage transition (an
    # axis drop) is one all-gather over that axis — keep the parent
    # implementation with its per-level constraint.

    def prolong(self, lev, pc, as_quads: bool = False):
        from ..ops.relax_compact import QuadField
        shf, shc = self.plan.shards[lev], self.plan.shards[lev + 1]
        if not (shf.sharded and shc.sharded
                and shf.shard_py == shc.shard_py
                and shf.shard_px == shc.shard_px):
            # replicated coarse level, or a stage transition (different
            # active axes): the GSPMD path inserts the re-shard collective
            # (quad coarse state is merged by to_full, locally if sharded)
            return super().prolong(lev, pc, as_quads=as_quads)

        nz_f = self.levels[lev].nzg
        interp = self.cfg.interp_type
        aggressive = self.levels[lev + 1].aggressive_from_prev
        pya, pxa = self._axes(lev)
        sp3c, sp3f = self.plan.spec(lev + 1, 3), self.plan.spec(lev, 3)

        def local(pc_l):
            # quad-persistent coarse state merges LOCALLY (1/8-size
            # interleave); the fine output stays in quads when the fine
            # level is quad-persistent — no fine-level interleave at all
            # (transfer.prolong_3d_linear_quads)
            if isinstance(pc_l, QuadField):
                pc_l = pc_l.merge()
            out = transfer.prolong(halo_extend(pc_l, pya, pxa), nz_f,
                                   interp, aggressive=aggressive,
                                   as_quads=as_quads)
            return QuadField.fromdict(out) if as_quads else out

        f = jax.shard_map(local, mesh=self.plan.mesh,
                          in_specs=(sp3c,), out_specs=sp3f)
        return f(pc)


jax.tree_util.register_pytree_node(
    ShardMapBackend,
    ShardMapBackend.tree_flatten,
    ShardMapBackend.tree_unflatten)
