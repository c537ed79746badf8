"""Multigrid cycle orchestration: V-cycles, F-cycles, outer solve.

JAX port of ``src/mg_solvers.f90``.  Levels are trace-time static, so
``fcycle``/``vcycle`` unroll into one fixed XLA DAG; the only host sync is
the once-per-F-cycle residual-norm fetch that drives the convergence loop
(exactly the reference's per-iteration ALLREDUCE + host test,
mg_solvers.f90:61-79).

The per-level operations are supplied by a *backend* object so the same
cycle code runs single-device (backend = :class:`SingleDeviceBackend`) and
distributed (mgroms_jax.parallel) — the backend owns halo extension,
restriction/prolongation (incl. any resharding), relaxation and global
reductions.

One deliberate deviation: the reference's V-cycle down-leg calls
``compute_residual`` which also reduces the global norm (an ALLREDUCE per
level per cycle) and throws the value away.  We compute the residual field
only; norms are evaluated once per outer iteration.  The iterates are
bit-identical; only dead reductions are dropped.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .assembly import LevelOperator
from .bc import extend_h1
from .config import SolverConfig
from .levels import LevelSpec
from .ops import relax as relax_ops
from .ops import stencil, transfer
from .platform import kernel_allowed


def _arrays_platform(ops) -> str:
    """Platform of the operator arrays (where the solve will run)."""
    try:
        return next(iter(ops[0].cA.devices())).platform
    except Exception:
        # tracers / unusual containers: the default device
        return jax.devices()[0].platform


def compact_eligible(spec: LevelSpec, cfg: SolverConfig) -> bool:
    """Quad-parity compact relax eligibility (single-shard form): 8-band
    RB/FC levels with even horizontal extents."""
    return (cfg.compact and spec.nd == 8
            and cfg.relax_kind in ("RB", "FC")
            and spec.nyg % 2 == 0 and spec.nxg % 2 == 0)


def build_relax_packs(levels, ops, cfg: SolverConfig,
                      eligible=None) -> list:
    """Persisted gather-block operators (CompactPack) for the levels whose
    smoothing will run the compact path; None elsewhere.  One-time work —
    call under jit alongside assembly.  With ``cfg.fused_bands_bf16`` every
    pack also carries the low-precision smoother operator (attach_lp)."""
    from .ops.relax_compact import attach_lp, build_compact_pack
    packs = []
    for lev, spec in enumerate(levels):
        ok = (compact_eligible(spec, cfg) if eligible is None
              else eligible[lev])
        if not ok:
            packs.append(None)
            continue
        pack = build_compact_pack(ops[lev].cA, cfg.cmatrix == "real")
        if cfg.fused_bands_bf16 and jnp.dtype(cfg.dtype).itemsize <= 4:
            # low-precision smoother blocks; residuals keep true f32 A
            pack = attach_lp(pack)
        packs.append(pack)
    return packs


class SingleDeviceBackend:
    """All per-level ops on one device (physical BCs on every edge).

    Registered as a JAX pytree (operator arrays are leaves, the level plan
    and config are static aux data) so jitted solver steps take the backend
    as a *traced argument* — embedding multi-MB coefficient arrays as HLO
    constants is poison for compile time.
    """

    def __init__(self, levels: List[LevelSpec], ops: List[LevelOperator],
                 cfg: SolverConfig, platform: Optional[str] = None,
                 packs: Optional[list] = None):
        self.levels = tuple(levels)
        self.ops = list(ops)
        self.cfg = cfg
        self.nlevs = len(levels)
        # the platform the OPERATOR ARRAYS live on (not jax.devices()[0]):
        # a CPU-hosted f64 model in a GPU session (refine.py) must gate off
        # the GPU kernel.  Captured once at construction
        # (arrays are concrete there) and carried through tree_flatten so
        # traced re-constructions keep it.
        self.platform = platform or _arrays_platform(ops)
        # persisted compact-smoother operators (build_relax_packs); None
        # per level when the compact path is ineligible there
        self.packs = list(packs) if packs is not None else [None] * len(levels)

    def tree_flatten(self):
        return (self.ops, self.packs), (self.levels, self.cfg, self.platform)

    @classmethod
    def tree_unflatten(cls, aux, children):
        levels, cfg, platform = aux
        return cls(list(levels), list(children[0]), cfg, platform=platform,
                   packs=list(children[1]))

    # -- halos -------------------------------------------------------------
    def extend(self, lev: int, x: jnp.ndarray) -> jnp.ndarray:
        return extend_h1(x)

    # -- smoothing / residual ---------------------------------------------
    def _use_compact(self, lev: int) -> bool:
        """Quad-parity compact relax: single-shard physical-BC form only
        (the distributed backend overrides this for sharded levels)."""
        return compact_eligible(self.levels[lev], self.cfg)

    # -- quad-persistent state (see ops/relax_compact.QuadField) -----------
    def state_quads(self, lev: int) -> bool:
        """Levels whose V-cycle state stays in quad-parity layout (no
        split/merge/interleave between consecutive compact-smoother ops).
        The coarsest level is excluded (its relax may be the dense direct
        solve / plain path on tiny arrays)."""
        return lev < self.nlevs - 1 and self._use_compact(lev)

    def to_state(self, lev: int, x):
        """Full array -> this level's canonical cycle state."""
        from .ops.relax_compact import QuadField
        if self.state_quads(lev) and not isinstance(x, QuadField):
            return QuadField.split(x)
        return x

    def to_full(self, lev: int, x):
        from .ops.relax_compact import QuadField
        return x.merge() if isinstance(x, QuadField) else x

    def _relax_quads(self, lev: int, p, b, nsweeps: int):
        """Quad-native smoothing (p, b are QuadFields)."""
        from .ops.relax_compact import QuadField
        pack = self._pack_or_build(lev)
        if self._use_kernel(lev):
            from .ops.pallas.relax_tiled import relax_compact_tiled_quads
            q = relax_compact_tiled_quads(
                p.asdict(), b.asdict(), pack, nsweeps, self.cfg.relax_kind,
                self.cfg.cmatrix == "real",
                interpret=self.cfg.pallas_interpret)
        else:
            from .ops.relax_compact import relax_compact_quads
            q = relax_compact_quads(
                p.asdict(), b.asdict(), pack, nsweeps, self.cfg.relax_kind,
                self.cfg.cmatrix == "real",
                tridiag_method=self.cfg.tridiag)
        return QuadField.fromdict(q)

    def relax(self, lev: int, p, b, nsweeps: int):
        from .ops.relax_compact import QuadField
        if isinstance(p, QuadField):
            return self._relax_quads(lev, p, b, nsweeps)
        spec = self.levels[lev]
        if (lev == self.nlevs - 1 and self.cfg.coarsest == "direct"
                and self.ops[lev].Ainv is not None):
            # exact coarse solve: one (nc, nc) matvec replaces ns_coarsest
            # relaxation sweeps; HIGHEST keeps a float32 product out of
            # TF32 on GPUs
            n = spec.nzg * spec.nyg * spec.nxg
            x = jnp.matmul(self.ops[lev].Ainv, b.reshape(n),
                           precision=jax.lax.Precision.HIGHEST)
            return x.reshape(spec.nzg, spec.nyg, spec.nxg)
        if spec.nd == 5:
            # Dead-on-arrival in the reference too: define_matrix has no
            # 2-D assembly branch (mg_define_matrix.f90) and the level plan
            # keeps nz >= 2 (mg_grids.f90:485).  An 8-band cA fed to a
            # 5-band smoother would be silently misinterpreted — refuse.
            raise NotImplementedError(
                "2-D (nz==1) levels are unreachable under the standard plan "
                "and have no assembly path (parity with the reference)")
        if self.cfg.relax_kind == "GS" and self.cfg.gs_exact:
            # reference-order sequential GS (parity mode; see config)
            return relax_ops.relax_gs_exact(
                p, b, self.ops[lev].cA, nsweeps,
                self.cfg.cmatrix == "real",
                extend_fn=lambda x: self.extend(lev, x))
        if self._use_compact(lev):
            if self._use_kernel(lev):
                from .ops.pallas.relax_tiled import relax_compact_tiled
                return relax_compact_tiled(p, b, self.packs[lev], nsweeps,
                                           self.cfg.relax_kind,
                                           self.cfg.cmatrix == "real",
                                           interpret=self.cfg.pallas_interpret,
                                           cA=self.ops[lev].cA)
            from .ops.relax_compact import relax_compact
            return relax_compact(p, b, self.ops[lev].cA, nsweeps,
                                 self.cfg.relax_kind,
                                 self.cfg.cmatrix == "real",
                                 tridiag_method=self.cfg.tridiag,
                                 pack=self.packs[lev])
        return relax_ops.relax(
            p, b, self.ops[lev].cA, nsweeps, self.cfg.relax_kind,
            self.cfg.cmatrix == "real",
            extend_fn=lambda x: self.extend(lev, x),
            tridiag_method=self.cfg.tridiag)

    def _use_kernel(self, lev: int) -> bool:
        """The Pallas color-update kernel on this level (8-band compact
        levels where platform.kernel_allowed says yes).  The distributed
        backend has its per-shard image (_use_kernel_shard)."""
        return (self.levels[lev].nd == 8
                and kernel_allowed(self.platform, self.cfg))

    # -- fused relax+residual ----------------------------------------------
    def supports_fused_residual(self, lev: int) -> bool:
        """Can relax at this level emit the post-sweep residual from its
        last color update (cfg.fused_residual)?  Quad-persistent RB levels
        only."""
        cfg = self.cfg
        # with bf16 smoother blocks the smoother runs the perturbed A'
        # operator — its in-sweep gather is not the true-A residual
        return (cfg.fused_residual and cfg.relax_kind == "RB"
                and self.state_quads(lev) and not cfg.fused_bands_bf16)

    def supports_fused_rr(self, lev: int) -> bool:
        """Fused relax + residual + restrict down-leg applicability (the
        standard 8:1 restriction only — aggressive z-coarsening keeps the
        two-call path)."""
        return (self.supports_fused_residual(lev)
                and lev + 1 < self.nlevs
                and not self.levels[lev + 1].aggressive_from_prev
                and self.levels[lev].nzg % 2 == 0)

    def _pack_or_build(self, lev: int):
        from .ops.relax_compact import build_compact_pack
        pack = self.packs[lev]
        if pack is None:
            pack = build_compact_pack(self.ops[lev].cA,
                                      self.cfg.cmatrix == "real")
        return pack

    def relax_residual(self, lev: int, p, b, nsweeps: int):
        """``nsweeps`` sweeps + the fresh post-sweep residual in one
        orchestration (supports_fused_residual levels; p, b QuadFields).
        Equal to relax followed by residual in exact arithmetic."""
        from .ops.relax_compact import QuadField
        pack = self._pack_or_build(lev)
        real = self.cfg.cmatrix == "real"
        if self._use_kernel(lev):
            from .ops.pallas.relax_tiled import relax_residual_tiled_quads
            q, rq = relax_residual_tiled_quads(
                p.asdict(), b.asdict(), pack, nsweeps, real,
                interpret=self.cfg.pallas_interpret)
        else:
            from .ops.relax_compact import relax_residual_compact_quads
            q, rq = relax_residual_compact_quads(
                p.asdict(), b.asdict(), pack, nsweeps, real,
                tridiag_method=self.cfg.tridiag)
        return QuadField.fromdict(q), QuadField.fromdict(rq)

    def relax_residual_restrict(self, lev: int, p, b, nsweeps: int,
                                as_quads: bool = False):
        """``nsweeps`` sweeps + coarse b = restrict(b - A p) in one
        orchestration — the V-cycle down-leg triple (supports_fused_rr
        levels).  Equal to relax followed by residual_restrict in exact
        arithmetic."""
        from .ops.relax_compact import QuadField
        pack = self._pack_or_build(lev)
        real = self.cfg.cmatrix == "real"
        if self._use_kernel(lev):
            from .ops.pallas.relax_tiled import \
                relax_residual_restrict_tiled_quads
            q, full = relax_residual_restrict_tiled_quads(
                p.asdict(), b.asdict(), pack, nsweeps, real,
                interpret=self.cfg.pallas_interpret)
        else:
            from .ops.relax_compact import \
                relax_residual_restrict_compact_quads
            q, full = relax_residual_restrict_compact_quads(
                p.asdict(), b.asdict(), pack, nsweeps, real,
                tridiag_method=self.cfg.tridiag)
        return (QuadField.fromdict(q),
                QuadField.split(full) if as_quads else full)

    def residual(self, lev: int, p, b):
        from .ops.relax_compact import QuadField
        if isinstance(p, QuadField):
            # quad-native residual (bitwise stencil.residual in quad form)
            # from the persisted gather blocks
            from .ops.relax_compact import residual_quads
            return QuadField.fromdict(residual_quads(
                p.asdict(), b.asdict(), self._pack_or_build(lev),
                self.cfg.cmatrix == "real"))
        return stencil.residual(self.extend(lev, p), b, self.ops[lev].cA,
                                self.cfg.cmatrix == "real")

    # -- transfers ---------------------------------------------------------
    def restrict(self, lev: int, r, as_quads: bool = False):
        """grid(lev)%r -> grid(lev+1)%b (fine2coarse, mg_intergrids.f90:16).
        ``r`` may be a QuadField (quad-persistent levels); ``as_quads``
        returns the coarse b in level lev+1's quad layout."""
        from .ops.relax_compact import QuadField, restrict_quads_to_full
        aggressive = self.levels[lev + 1].aggressive_from_prev
        if isinstance(r, QuadField):
            if aggressive:
                # z-only 8:1 coarsening: quads are independent in (y, x)
                out = QuadField(tuple(
                    transfer.restrict_aggressive(qq) for qq in r.quads))
                return out if as_quads else out.merge()
            full = restrict_quads_to_full(r.asdict())
        else:
            full = transfer.restrict(r, aggressive=aggressive)
        return QuadField.split(full) if as_quads else full

    def residual_restrict(self, lev: int, p, b, as_quads: bool = False):
        """Coarse b = restrict(b - A p) — the V-cycle down-leg pair
        (compute_residual + fine2coarse, mg_solvers.f90:137-140).  On
        quad-persistent levels the residual stays in quad layout and the
        restriction reads the quads directly."""
        return self.restrict(lev, self.residual(lev, p, b),
                             as_quads=as_quads)

    def prolong(self, lev: int, pc, as_quads: bool = False):
        """grid(lev+1)%p -> correction on lev (coarse2fine, :167-228).
        ``pc`` may be a QuadField; ``as_quads`` emits the fine correction in
        quad layout (no interleave — transfer.prolong_3d_linear_quads)."""
        from .ops.relax_compact import QuadField
        aggressive = self.levels[lev + 1].aggressive_from_prev
        pce = self.extend(lev + 1, self.to_full(lev + 1, pc))
        out = transfer.prolong(pce, self.levels[lev].nzg,
                               self.cfg.interp_type, aggressive=aggressive,
                               as_quads=as_quads)
        return QuadField.fromdict(out) if as_quads else out

    # -- reductions --------------------------------------------------------
    def norm_sq(self, lev: int, x) -> jnp.ndarray:
        from .ops.relax_compact import QuadField
        if isinstance(x, QuadField):
            return sum(jnp.sum(q * q) for q in x.quads)
        return jnp.sum(x * x)

    def zeros(self, lev: int, as_quads: bool = False):
        s = self.levels[lev]
        dt = self.ops[lev].cA.dtype
        if as_quads:
            from .ops.relax_compact import QuadField
            return QuadField(tuple(
                jnp.zeros((s.nzg, s.nyg // 2, s.nxg // 2), dtype=dt)
                for _ in range(4)))
        return jnp.zeros((s.nzg, s.nyg, s.nxg), dtype=dt)


jax.tree_util.register_pytree_node(
    SingleDeviceBackend,
    SingleDeviceBackend.tree_flatten,
    SingleDeviceBackend.tree_unflatten)


def _q(backend, lev: int) -> bool:
    """Quad-persistent state at this level?  (ops/relax_compact.QuadField —
    keeps the compact smoother's quad layout across the whole cycle; no
    split/merge/interleave between consecutive hot ops.)"""
    fn = getattr(backend, "state_quads", None)
    return bool(fn(lev)) if fn is not None else False


def _is_quads(p) -> bool:
    from .ops.relax_compact import QuadField
    return isinstance(p, QuadField)


def _fused_rr_ok(backend, lev: int, nsweeps: int, p) -> bool:
    fn = getattr(backend, "supports_fused_rr", None)
    return (nsweeps >= 1 and _is_quads(p)
            and fn is not None and bool(fn(lev)))


def _fused_res_ok(backend, lev: int, nsweeps: int, p) -> bool:
    fn = getattr(backend, "supports_fused_residual", None)
    return (nsweeps >= 1 and _is_quads(p)
            and fn is not None and bool(fn(lev)))


def vcycle(backend, ps: list, bs: list, top: int, cfg: SolverConfig,
           emit_top_residual: bool = False):
    """One V-cycle from level ``top`` down (``Vcycle``,
    mg_solvers.f90:129-151).  Returns ``(ps, r_top)`` — ``r_top`` is the
    fresh level-``top`` residual when ``emit_top_residual`` and the
    backend fuses it into the final post-smoothing sweep, else None (the
    caller computes it the plain way).  All fused variants equal the
    two-call forms in exact arithmetic (cfg.fused_residual; ~1 ulp of
    XLA recompilation noise across the peeled final sweep)."""
    L = backend.nlevs
    for lev in range(top, L - 1):
        if _fused_rr_ok(backend, lev, cfg.ns_pre, ps[lev]):
            ps[lev], bs[lev + 1] = backend.relax_residual_restrict(
                lev, ps[lev], bs[lev], cfg.ns_pre,
                as_quads=_q(backend, lev + 1))
        else:
            ps[lev] = backend.relax(lev, ps[lev], bs[lev], cfg.ns_pre)
            bs[lev + 1] = backend.residual_restrict(
                lev, ps[lev], bs[lev], as_quads=_q(backend, lev + 1))
        ps[lev + 1] = backend.zeros(lev + 1, as_quads=_q(backend, lev + 1))
    ps[L - 1] = backend.relax(L - 1, ps[L - 1], bs[L - 1], cfg.ns_coarsest)
    r_top = None
    for lev in range(L - 2, top - 1, -1):
        ps[lev] = ps[lev] + backend.prolong(lev, ps[lev + 1],
                                            as_quads=_q(backend, lev))
        if (lev == top and emit_top_residual
                and _fused_res_ok(backend, lev, cfg.ns_post, ps[lev])):
            ps[lev], r_top = backend.relax_residual(lev, ps[lev], bs[lev],
                                                    cfg.ns_post)
        else:
            ps[lev] = backend.relax(lev, ps[lev], bs[lev], cfg.ns_post)
    return ps, r_top


def fcycle(backend, p0, b0, r0, cfg: SolverConfig,
           keep_state: bool = False, emit_residual: bool = False):
    """One F-cycle (``Fcycle``, mg_solvers.f90:104-126).

    Restricts the *current residual* r0 down all levels (the down-leg
    ``fine2coarse`` reads grid%r, :113), relaxes the coarsest, then per
    level applies the coarse correction and runs a V-cycle from there.

    Contract: full arrays in, full array out by default; quad-persistent
    levels convert at this boundary only (once per F-cycle, not per op).
    With ``keep_state=True`` the level-0 arguments may already be in the
    level's canonical state layout (QuadField) and the result is returned
    in it — the outer solve loop then never leaves quad layout (solve_p /
    bench carry state across F-cycles; the only full-array conversions are
    one split per solve and one merge of the final pressure).

    With ``emit_residual=True`` returns ``(p, r)`` where ``r`` is the
    fresh level-0 residual when the backend fuses it into the final
    post-smoothing sweep (None otherwise — the caller falls back to a
    plain residual call).
    """
    L = backend.nlevs
    ps = [None] * L
    bs = [None] * L
    to_state = getattr(backend, "to_state", lambda lev, x: x)
    to_full = getattr(backend, "to_full", lambda lev, x: x)
    ps[0], bs[0] = to_state(0, p0), to_state(0, b0)
    r = to_state(0, r0) if keep_state else r0   # level-0 residual
    for lev in range(0, L - 1):
        bs[lev + 1] = backend.restrict(lev, r,
                                       as_quads=_q(backend, lev + 1))
        ps[lev + 1] = backend.zeros(lev + 1, as_quads=_q(backend, lev + 1))
        r = bs[lev + 1]           # coarse residual (p=0) == b (:114)
    ps[L - 1] = backend.relax(L - 1, ps[L - 1], bs[L - 1], cfg.ns_coarsest)
    r_top = None
    for lev in range(L - 2, -1, -1):
        ps[lev] = ps[lev] + backend.prolong(lev, ps[lev + 1],
                                            as_quads=_q(backend, lev))
        ps, r_top = vcycle(backend, ps, bs, lev, cfg,
                           emit_top_residual=emit_residual and lev == 0)
    p = ps[0] if keep_state else to_full(0, ps[0])
    return (p, r_top) if emit_residual else p


def vcycle2(backend, ps: list, bs: list, top: int, bottom: int,
            cfg: SolverConfig) -> list:
    """Partial-depth V-cycle: descend only to level ``bottom``
    (``Vcycle2``, mg_solvers.f90:155-177)."""
    for lev in range(top, bottom):
        if _fused_rr_ok(backend, lev, cfg.ns_pre, ps[lev]):
            ps[lev], bs[lev + 1] = backend.relax_residual_restrict(
                lev, ps[lev], bs[lev], cfg.ns_pre)
        else:
            ps[lev] = backend.relax(lev, ps[lev], bs[lev], cfg.ns_pre)
            bs[lev + 1] = backend.residual_restrict(lev, ps[lev], bs[lev])
        ps[lev + 1] = backend.zeros(lev + 1)
    ps[bottom] = backend.relax(bottom, ps[bottom], bs[bottom],
                               cfg.ns_coarsest)
    for lev in range(bottom - 1, top - 1, -1):
        ps[lev] = ps[lev] + backend.prolong(lev, ps[lev + 1])
        ps[lev] = backend.relax(lev, ps[lev], bs[lev], cfg.ns_post)
    return ps


def dot(backend, lev: int, x, y) -> jnp.ndarray:
    """Global <x, y> over the interior (``norm``, mg_solvers.f90:180-200).
    Under GSPMD a plain sum over (sharded) global arrays IS the ALLREDUCE."""
    del backend, lev
    return jnp.sum(x * y)


def testgalerkin(backend, lev: int, cfg: SolverConfig, seed: int = 0,
                 field: str = "smooth"):
    """Inter-grid/operator consistency diagnostic (``testgalerkin``,
    mg_solvers.f90:203-288): prolong a coarse field p, compare <p, A_c p>
    against <P p, A_f P p>.  Both approximate the same energy integral
    for smooth fields, so norm_c/norm_f*4 ~ 4 (the expectation at
    :281-286).  ``field='smooth'`` is the Gaussian bump of the reference's
    commented variant (:226-232); ``'random'`` matches the live code path
    (:224) and yields a larger ratio because trilinear interpolation damps
    the rough modes' energy.

    Returns (norm_coarse, norm_fine, ratio = norm_c / norm_f * 4).
    """
    import jax as _jax
    s = backend.levels[lev]
    dt = backend.ops[lev].cA.dtype
    if field == "random":
        key = _jax.random.PRNGKey(seed)
        p_c = _jax.random.uniform(key, (s.nzg, s.nyg, s.nxg), dtype=dt)
    else:
        x = (jnp.arange(s.nxg, dtype=dt) + 0.5) / s.nxg - 0.3
        y = (jnp.arange(s.nyg, dtype=dt) + 0.5) / s.nyg - 0.4
        z = (jnp.arange(s.nzg, dtype=dt) + 0.5) / s.nzg - 0.2
        p_c = jnp.exp(-30.0 * (x[None, None, :] ** 2 + y[None, :, None] ** 2
                               + z[:, None, None] ** 2))
    r_c = -backend.residual(lev, p_c, jnp.zeros_like(p_c))   # A_c p
    norm_c = jnp.sum(p_c * r_c)
    p_f = backend.prolong(lev - 1, p_c)                      # P p
    r_f = -backend.residual(lev - 1, p_f, jnp.zeros_like(p_f))
    norm_f = jnp.sum(p_f * r_f)
    return float(norm_c), float(norm_f), float(norm_c / norm_f * 4.0)


# Module-level jitted entry points.  The backend is a pytree ARGUMENT, not
# a closure capture: its coefficient arrays must be traced inputs, never
# HLO constants (multi-MB constants wreck compile time).  Module scope
# keeps the jit cache warm across repeated solves.
@jax.jit
def solve_init(be, b):
    """p = 0, ||b||, initial residual and relative norm
    (solve_p prologue, mg_solvers.f90:35-57).

    State (p, b, r) is created/kept in level 0's canonical layout
    (QuadField on quad-persistent levels): the outer loop never pays the
    split/merge boundary per cycle."""
    q = bool(getattr(be, "state_quads", lambda lev: False)(0))
    to_state = getattr(be, "to_state", lambda lev, x: x)
    p = be.zeros(0, as_quads=q)
    bnorm = jnp.sqrt(be.norm_sq(0, b))
    bs = to_state(0, b)
    r = be.residual(0, p, bs)
    rnorm = jnp.sqrt(be.norm_sq(0, r))
    return p, bs, r, rnorm / bnorm, bnorm


from functools import partial


def cycle_step(be, p, b, r, cfg):
    """One F-cycle + fresh residual — the convergence-loop body shared by
    solve_step and the benches.

    Default: the reference structure (Fcycle acts on (p, b) directly,
    mg_solvers.f90:61-79).  With low-precision smoother bands
    (cfg.fused_bands_bf16) the step runs in DEFECT-CORRECTION form
    instead: p += Fcycle(0, r, r).  The two are identical in exact
    arithmetic (relaxation is shift-invariant: relax(p+x, b) =
    p + relax(x, b-Ap)), but with a perturbed smoother operator A' the
    direct form's fixed point is biased away from A⁻¹b by O(|A-A'|) — a
    relative-residual FLOOR (~5e-4 measured with bf16 bands) — while in
    defect form the perturbation multiplies the current error, degrading
    only the convergence FACTOR by O(0.4%): classical mixed-precision
    iterative refinement, with the f32 true-A residual steering."""
    if cfg.fused_bands_bf16:
        # defect form: the in-sweep residual would be the INNER system's
        # (r - A e), not b - A p — always compute the outer one fresh
        from .ops.relax_compact import QuadField
        z = be.zeros(0, as_quads=isinstance(p, QuadField))
        p = p + fcycle(be, z, r, r, cfg, keep_state=True)
        r = be.residual(0, p, b)
    else:
        p, r = fcycle(be, p, b, r, cfg, keep_state=True, emit_residual=True)
        if r is None:
            r = be.residual(0, p, b)
    return p, r


@partial(jax.jit, static_argnames=("cfg",))
def solve_step(be, p, b, r, cfg):
    """One convergence-loop iteration: cycles_per_check F-cycles + fresh
    residual + norm (mg_solvers.f90:61-79 body).  p/b/r are level-0 STATE
    (QuadField on quad-persistent levels) — carried across F-cycles."""
    for _ in range(cfg.cycles_per_check):
        p, r = cycle_step(be, p, b, r, cfg)
    rnorm = jnp.sqrt(be.norm_sq(0, r))
    return p, r, rnorm


@partial(jax.jit, static_argnames=("cfg", "maxiter"))
def _solve_device_loop(be, b, cfg, tol, maxiter):
    """Whole outer convergence loop as ONE on-device program
    (lax.while_loop): p=0 init, then F-cycles until ||r||/||b|| <= tol or
    ``maxiter``, recording the per-cycle relative residual into a
    preallocated history array.  One device->host fetch per SOLVE instead
    of one per cycle — the reference's host loop costs an ALLREDUCE per
    iteration (mg_solvers.f90:61-79), ~free on its cluster; on an
    accelerator each host sync also stalls the dispatch queue.

    Returns (p_state, r_state, niter, history[maxiter+1]) with history
    slots beyond niter holding NaN."""
    q = bool(getattr(be, "state_quads", lambda lev: False)(0))
    to_state = getattr(be, "to_state", lambda lev, x: x)
    p = be.zeros(0, as_quads=q)
    bnorm = jnp.sqrt(be.norm_sq(0, b))
    bs = to_state(0, b)
    r = be.residual(0, p, bs)
    res0 = jnp.sqrt(be.norm_sq(0, r)) / bnorm
    # sized so the last body iteration's i = maxiter-1 + cycles_per_check
    # is always in range (an out-of-bounds .at[].set is silently DROPPED
    # by XLA, which would leave the final residual out of the history
    # whenever cycles_per_check does not divide maxiter)
    hist = jnp.full((maxiter + cfg.cycles_per_check,), jnp.nan,
                    dtype=res0.dtype)
    hist = hist.at[0].set(res0)

    def cond(c):
        i, p, r, res, hist = c
        return (i < maxiter) & (res > tol)

    def body(c):
        i, p, r, res, hist = c
        for _ in range(cfg.cycles_per_check):
            p, r = cycle_step(be, p, bs, r, cfg)
        res = jnp.sqrt(be.norm_sq(0, r)) / bnorm
        i = i + cfg.cycles_per_check
        return (i, p, r, res, hist.at[i].set(res))

    i, p, r, res, hist = jax.lax.while_loop(
        cond, body, (jnp.int32(0), p, r, res0, hist))
    return p, r, i, hist


class SolveInfo(NamedTuple):
    niter: int
    res: float                 # final relative residual ||r||/||b||
    history: tuple             # relative residual after each F-cycle
    time_s: float
    rescaled_perf: float       # reference figure of merit (mg_solvers.f90:92)


def solve_p(backend, b: jnp.ndarray, cfg: Optional[SolverConfig] = None,
            tol: Optional[float] = None, maxiter: Optional[int] = None,
            verbose: bool = False, device_loop: Optional[bool] = None
            ) -> Tuple[jnp.ndarray, SolveInfo]:
    """Outer convergence loop (``solve_p``, mg_solvers.f90:17-101).

    Starts from p = 0 (:35), iterates F-cycles until the relative residual
    ||b - Ap|| / ||b|| drops under ``tol`` or ``maxiter`` cycles (:61-79).
    Returns the pressure and a :class:`SolveInfo` with the residual history
    and the reference "rescaled performance" metric.

    ``device_loop`` (default: cfg.device_loop) runs the whole loop as one
    on-device ``lax.while_loop`` program — identical iterates and history,
    but one host sync per solve instead of per cycle (the host loop
    remains the default = reference parity, including its per-iteration
    verbose/netcdf hooks).
    """
    cfg = cfg or backend.cfg
    tol = cfg.solver_prec if tol is None else tol
    maxiter = cfg.solver_maxiter if maxiter is None else maxiter
    if device_loop is None:
        device_loop = cfg.device_loop

    to_full = getattr(backend, "to_full", lambda lev, x: x)
    if device_loop and not (verbose or cfg.netcdf_output):
        import math
        t0 = time.perf_counter()
        p, r, niter, hist = _solve_device_loop(backend, b, cfg,
                                               tol, maxiter)
        p = to_full(0, p)
        jax.block_until_ready(p)
        dt = time.perf_counter() - t0
        niter = int(niter)
        hist = [float(h) for h in hist[:niter + 1]]
        hist = [h for h in hist if not math.isnan(h)]
        # b == 0 makes every entry 0/0 = NaN (the host loop returns the
        # same degenerate history=(nan,)); keep the shape of that contract
        if not hist:
            hist = [float("nan")]
        res = hist[-1]
        s = backend.levels[0]
        ncores = getattr(backend, "ndevices", 1)
        decades = (-math.log10(max(res / hist[0], 1e-300))
                   if niter else float("nan"))
        perf = (dt * ncores / decades / (s.nxg * s.nyg * s.nzg)
                if decades and decades > 0 else float("nan"))
        return p, SolveInfo(niter=niter, res=res, history=tuple(hist),
                            time_s=dt, rescaled_perf=perf)
    t0 = time.perf_counter()
    p, bs, r, res0, bnorm = solve_init(backend, b)
    res0 = float(res0)
    r0val = res0
    history = [res0]
    nite = 0
    while nite < maxiter and res0 > tol:
        p, r, rnorm = solve_step(backend, p, bs, r, cfg)
        rnorm = float(rnorm) / float(bnorm)
        conv = res0 / rnorm if rnorm > 0 else float("inf")
        res0 = rnorm
        nite += cfg.cycles_per_check
        history.append(rnorm)
        if verbose:
            print(f"ite = {nite:2d}: res = {rnorm:10.3e} / conv = {conv:10.3f}")
        if cfg.netcdf_output:
            # per-iteration p/r dumps (mg_solvers.f90:74-77)
            import os
            from .io.diagnostics import write_field
            write_field(to_full(0, p), "p",
                        os.path.join(cfg.output_dir, "p.nc"),
                        rank=0, iteration=nite)
            write_field(to_full(0, r), "r",
                        os.path.join(cfg.output_dir, "r.nc"),
                        rank=0, iteration=nite)
    p = to_full(0, p)
    jax.block_until_ready(p)
    dt = time.perf_counter() - t0
    if cfg.netcdf_output:
        # end-of-solve dumps (nhydro.f90:92-95)
        import os
        from .io.diagnostics import write_field
        write_field(p, "p", os.path.join(cfg.output_dir, "p_end.nc"), rank=0)
        write_field(to_full(0, r), "r",
                    os.path.join(cfg.output_dir, "r_end.nc"), rank=0)

    # rescaled performance (mg_solvers.f90:84-97): core-seconds per DOF per
    # decade of residual reduction
    import math
    s = backend.levels[0]
    ncores = getattr(backend, "ndevices", 1)
    decades = -math.log10(max(res0 / r0val, 1e-300)) if nite else float("nan")
    perf = (dt * ncores / decades / (s.nxg * s.nyg * s.nzg)
            if decades and decades > 0 else float("nan"))
    return p, SolveInfo(niter=nite, res=res0, history=tuple(history),
                        time_s=dt, rescaled_perf=perf)
