"""Compact checkerboard (quad-parity) red-black line relaxation.

The masked RB sweep (ops/relax.py) evaluates the tridiagonal RHS gather and
the Thomas solve on EVERY column, then commits only the active color — half
the gather and solve work is thrown away.  This module stores the state in
*quad-parity* form — four arrays ``Q[a][b] = p[:, a::2, b::2]`` of shape
(nz, ny/2, nx/2) — so a color update computes exactly the active columns
and nothing else: the two quads of one checkerboard color are updated from
shifted reads of the complementary quads.  Same arithmetic, same term order,
half the flops (bitwise-equal iterates up to XLA scheduling).

Index algebra: a point (j, i) = (2J+a, 2I+b); a neighbour offset (dj, di)
lands in quad (a', b') = ((a+dj)%2, (b+di)%2) at quad index
(J + (a+dj-a')/2, I + (b+di-b')/2) — i.e. each stencil term is ONE
unstrided shifted slice of one quad.  Quad halos (the j=-1/ny, i=-1/nx
mirror ring of bc.extend_h1) come from sibling quads:
``Q[1][b]`` row -1 ↔ full j=-1 = p[0] = ``Q[0][b]`` row 0, etc.

Reference semantics preserved (mg_relax.f90:151-334): exact z-line Thomas
solve per column, halo/BC refresh per color, ``cmatrix='real'`` bottom-level
horizontal-diagonal couplings read pre-color values of the same color
(the documented vectorization deviation of ops/relax.py applies unchanged).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .relax import thomas_factor, tridiag, tridiag_factored, tridiag_pcr
from .transfer import _interleave

Quads = Dict[Tuple[int, int], jnp.ndarray]

# target-quad key order used everywhere a pack is indexed
_TKEYS = ((0, 0), (0, 1), (1, 0), (1, 1))


def split_quads(x: jnp.ndarray) -> Quads:
    """(nz, ny, nx) -> {(a, b): x[:, a::2, b::2]} via strided slices.

    """
    return {(a, b): x[:, a::2, b::2] for a in (0, 1) for b in (0, 1)}


@jax.tree_util.register_pytree_node_class
class QuadField:
    """A level state persisted in quad-parity layout across the V-cycle.

    Keeping the state in quads between operations removes every
    split/merge and interleave from the cycle hot path; merging back to
    the full array happens once per F-cycle at the fine level
    (solver.fcycle boundary).

    Supports ``+`` (the prolongation's additive correction,
    mg_intergrids.f90:224-226) elementwise per quad.
    """

    __slots__ = ("quads",)

    def __init__(self, quads):
        self.quads = tuple(quads)          # _TKEYS order

    def tree_flatten(self):
        return self.quads, None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children)

    def __add__(self, other):
        return QuadField(tuple(a + b for a, b in
                               zip(self.quads, other.quads)))

    def asdict(self) -> Quads:
        return dict(zip(_TKEYS, self.quads))

    @classmethod
    def fromdict(cls, q: Quads) -> "QuadField":
        return cls(tuple(q[t] for t in _TKEYS))

    @classmethod
    def split(cls, x: jnp.ndarray) -> "QuadField":
        return cls.fromdict(split_quads(x))

    def merge(self) -> jnp.ndarray:
        return merge_quads(self.asdict())


def merge_quads(q: Quads) -> jnp.ndarray:
    """Inverse of :func:`split_quads`: interleave in y, then in x
    (ops/transfer._interleave)."""
    col0 = _interleave(q[(0, 0)], q[(1, 0)], axis=-2)
    col1 = _interleave(q[(0, 1)], q[(1, 1)], axis=-2)
    return _interleave(col0, col1, axis=-1)


def quad_ext_bands(ce: jnp.ndarray) -> Quads:
    """Quad-sample a halo-extended field ``ce`` (..., ny+2, nx+2) into four
    extended quads (..., H+2, W+2).

    Extended row R of quad a holds full j = 2(R-1)+a; valid j ∈ [-1, ny]
    all come from ``ce`` (rows je = j+1); the two never-read junk rows
    (j = -2 for a=0, j = ny+1 for a=1) are edge duplicates.  Used once per
    relax call on the 8 operator bands (stride-2 slices, amortized over
    2*nsweeps color updates).
    """
    odd_j = ce[..., 1::2, :]       # j = 0, 2, ..., ny      (H+1 rows)
    even_j = ce[..., 0::2, :]      # j = -1, 1, ..., ny-1   (H+1 rows)
    rows = {0: jnp.concatenate([odd_j[..., :1, :], odd_j], axis=-2),
            1: jnp.concatenate([even_j, even_j[..., -1:, :]], axis=-2)}
    out = {}
    for a in (0, 1):
        r = rows[a]
        odd_i = r[..., :, 1::2]
        even_i = r[..., :, 0::2]
        out[(a, 0)] = jnp.concatenate([odd_i[..., :, :1], odd_i], axis=-1)
        out[(a, 1)] = jnp.concatenate([even_i, even_i[..., :, -1:]], axis=-1)
    return out


def extend_quads(q: Quads) -> Quads:
    """Halo-1 extension of the four quad arrays with the physical
    homogeneous-Neumann mirror rule of bc.extend_h1 (edge copy), halos
    sourced from sibling quads.  Pure concats — XLA fuses them into the
    consuming stencil reads."""
    rj = {}
    for b in (0, 1):
        q0, q1 = q[(0, b)], q[(1, b)]
        # quad 0 rows: [junk(j=-2), j=0..ny-2, halo j=ny = p[ny-1] = q1[-1]]
        rj[(0, b)] = jnp.concatenate([q0[:, :1], q0, q1[:, -1:]], axis=1)
        # quad 1 rows: [halo j=-1 = p[0] = q0[0], j=1..ny-1, junk(j=ny+1)]
        rj[(1, b)] = jnp.concatenate([q0[:, :1], q1, q1[:, -1:]], axis=1)
    e = {}
    for a in (0, 1):
        r0, r1 = rj[(a, 0)], rj[(a, 1)]
        e[(a, 0)] = jnp.concatenate([r0[:, :, :1], r0, r1[:, :, -1:]], axis=2)
        e[(a, 1)] = jnp.concatenate([r0[:, :, :1], r1, r1[:, :, -1:]], axis=2)
    return e


def _kshift(x: jnp.ndarray, dk: int) -> jnp.ndarray:
    """Zero-padded k-shift (no vertical halo — BCs live in the bands)."""
    if dk == 0:
        return x
    z = jnp.zeros_like(x[:1])
    if dk == 1:
        return jnp.concatenate([x[1:], z], axis=0)
    return jnp.concatenate([z, x[:-1]], axis=0)


def _qread(e: Quads, a: int, b: int, dj: int, di: int, dk: int = 0
           ) -> jnp.ndarray:
    """Value at offset (dk, dj, di) from every target-quad-(a,b) point:
    one shifted interior slice of the source quad."""
    a2, b2 = (a + dj) % 2, (b + di) % 2
    rj = (a + dj - a2) // 2
    ri = (b + di - b2) // 2
    x = e[(a2, b2)]
    H, W = x.shape[-2] - 2, x.shape[-1] - 2
    return _kshift(x[:, 1 + rj:1 + rj + H, 1 + ri:1 + ri + W], dk)


# The neighbour gather for one target quad, term for term the quad form of
# ops/stencil.offdiag_columns (mg_relax.f90:263-300).  Each term multiplies
# a BAND read at a fixed (dk, dj, di) offset — constant operator data — by a
# STATE read at a fixed offset.  The band reads are therefore pre-sliceable
# into aligned interior-quad-shaped blocks, persisted once per level
# (:class:`CompactPack`): the hot path never touches the extended band
# layout, and the Pallas kernel reads plane k of every block at the target
# columns' own offsets.
#
# Entries: (band n, (bk, bj, bi) band offset, (pk, pj, pi) state offset),
# in the exact summation order of the reference gather (bitwise-stable).
_BASE_TERMS = (
    (3, (0, 0, 0), (1, -1, 0)),
    (3, (-1, 1, 0), (-1, 1, 0)),
    (4, (0, 0, 0), (0, -1, 0)),
    (4, (0, 1, 0), (0, 1, 0)),
    (5, (0, 0, 0), (-1, -1, 0)),
    (5, (1, 1, 0), (1, 1, 0)),
    (6, (0, 0, 0), (1, 0, -1)),
    (6, (-1, 0, 1), (-1, 0, 1)),
    (7, (0, 0, 0), (0, 0, -1)),
    (7, (0, 0, 1), (0, 0, 1)),
    (8, (0, 0, 0), (-1, 0, -1)),
    (8, (1, 0, 1), (1, 0, 1)),
)
# bottom-level (k=1) horizontal-diagonal couplings, k0-masked
# (mg_relax.f90:271-276); the first/third band reads alias _BASE_TERMS
# entries so gather_keys dedupes them
_REAL_TERMS = (
    (5, (0, 0, 0), (0, 1, -1)),
    (5, (0, -1, 1), (0, -1, 1)),
    (8, (0, 0, 0), (0, -1, -1)),
    (8, (0, 1, 1), (0, 1, 1)),
)


def gather_keys(real_matrix: bool) -> tuple:
    """Unique (band, band-offset) reads of the gather, in first-use order —
    the per-target block list of a :class:`CompactPack` (12 keys, 14 when
    ``real_matrix``)."""
    keys = []
    terms = _BASE_TERMS + (_REAL_TERMS if real_matrix else ())
    for n, boff, _ in terms:
        k = (n, boff)
        if k not in keys:
            keys.append(k)
    return tuple(keys)


class CompactPack(NamedTuple):
    """Persisted per-level smoother operator in quad-gather layout.

    All fields are tuples indexed by target quad (``_TKEYS`` order).
    ``blocks[target]`` is the target's 12 BASE gather blocks
    concatenated along x into ONE wide array (nz, H, 12*W) in
    ``gather_keys(False)`` order (block m is columns [m*W, (m+1)*W);
    concat-then-slice is bitwise the separate-arrays form).  The two
    real-ONLY keys live in ``rblocks`` as their k=1 plane.  Use
    :func:`block_views` for the per-key views in full
    ``gather_keys(real)`` order.

    ``bet``/``gam`` are the precomputed Thomas pivots (ops/relax.
    thomas_factor): the smoothing hot path is division-free and skips the
    forward elimination entirely.  ``d`` is kept for the PCR option and the
    quad-form residual.
    """

    blocks: tuple    # per target: (nz, H, 12*W) wide base-key blocks
    d: tuple         # per target: (nz, H, W)   in-column diagonal
    ud: tuple        # per target: (nz-1, H, W) in-column off-diagonal
    bet: tuple       # per target: (nz, H, W)   reciprocal pivots
    gam: tuple       # per target: (nz-1, H, W) back-substitution multipliers
    real_matrix: bool
    # per target: (1, H, 2*W) — the two real-ONLY gather keys, stored as
    # their k=1 plane only: they are never read anywhere else
    # (mg_relax.f90:271-276), so carrying them full-depth would read
    # 2/14 more block bytes for 1/nz of the use.  None when
    # cmatrix != 'real'.
    rblocks: object = None
    # low-precision SMOOTHER operator (cfg.fused_bands_bf16):
    # (blocks_lp, rblocks_lp, bet_lp, gam_lp) with the gather blocks in
    # bfloat16 (halving the dominant block bytes) and the Thomas pivots
    # REBUILT from the rounded operator so diag = -(row sum) holds
    # (:func:`consistent_pivots`).  Smoothing only — residuals keep
    # the f32 true-A fields; the outer loop runs in defect-correction
    # form (solver.cycle_step).  None unless enabled.
    lp: object = None


jax.tree_util.register_pytree_node(
    CompactPack,
    lambda p: ((p.blocks, p.d, p.ud, p.bet, p.gam, p.rblocks, p.lp),
               p.real_matrix),
    lambda aux, c: CompactPack(*c[:5], real_matrix=aux, rblocks=c[5],
                               lp=c[6]))


def real_only_keys() -> tuple:
    """The gather keys that exist ONLY through the 'real' k=1 terms —
    gather_keys(True) minus gather_keys(False), in appended order."""
    base = set(gather_keys(False))
    return tuple(k for k in gather_keys(True) if k not in base)


def block_views(pack: CompactPack, m: int, lp: bool = False) -> tuple:
    """Per-key block views of target ``m`` in gather_keys(real) order:
    the 12 base keys are W-wide column slices of the wide array; the
    real-only keys are the (1, H, W) plane-0 halves of ``rblocks``
    (gather_blocks only ever reads their plane 0).  ``lp`` selects the
    low-precision smoother copies (pack.lp)."""
    wides = pack.lp[0] if lp else pack.blocks
    base = wide_slices(wides[m], len(gather_keys(False)))
    if not pack.real_matrix:
        return base
    rb = (pack.lp[1] if lp else pack.rblocks)[m]
    W = rb.shape[2] // 2
    return base + (rb[:, :, :W], rb[:, :, W:])


def smoother_operator(pack: CompactPack, m: int):
    """(block views, bet, gam) the SMOOTHER should use for target ``m`` —
    the low-precision consistent operator when present, else the true
    f32 one.  Residual paths must NOT use this (they need true A)."""
    if pack.lp is not None:
        return (block_views(pack, m, lp=True), pack.lp[2][m],
                pack.lp[3][m])
    return block_views(pack, m), pack.bet[m], pack.gam[m]


def consistent_pivots(pack: CompactPack, band_dtype) -> tuple:
    """Thomas pivots of the row-sum-CONSISTENT low-precision smoother
    operator.

    Storing the gather bands in bfloat16 while
    the Thomas pivots keep the f32 diagonal breaks the diag = -(row sum)
    identity the operator is built on (mg_define_matrix.f90:615-657) and
    the smoother amplifies the constant mode — CUC convergence collapses
    (rel residual 0.168 after 6 F-cycles vs 5.1e-05).  The fix: treat the
    ROUNDED bands as the smoother's operator A' and rebuild its diagonal
    so the row sums match A exactly:

        d' = d + gather(1, A - A')     (per row; ones-state gather)

    Rounding a persisted gather BLOCK equals rounding the band then
    slicing, so the per-row correction is one gather of the block deltas
    against an all-ones extended state (the same _kshift/k0 masking as
    the smoother applies, so boundary rows correct exactly).  A' stays
    symmetric (each band array serves both directions of its coupling
    pair) with A'·1 = A·1; the smoother then solves a ~0.4%-perturbed
    operator — a smoother for A in the classical perturbation sense —
    while residuals keep using A in f32.  Returns (bet', gam') per target
    (_TKEYS order), each thomas_factor(d', ud)."""
    bd = jnp.dtype(band_dtype)
    bets, gams = [], []
    for m, (a, b) in enumerate(_TKEYS):
        blocks = block_views(pack, m)
        deltas = tuple(x - x.astype(bd).astype(x.dtype) for x in blocks)
        nz, H, W = pack.d[m].shape
        dt = pack.d[m].dtype
        ones = jnp.ones((nz, H + 2, W + 2), dt)
        e1 = {t: ones for t in _TKEYS}
        d2 = pack.d[m] + gather_blocks(e1, deltas, a, b, pack.real_matrix)
        bet, gam = thomas_factor(d2, pack.ud[m])
        bets.append(bet)
        gams.append(gam)
    return tuple(bets), tuple(gams)


def attach_lp(pack: CompactPack, band_dtype=jnp.bfloat16) -> CompactPack:
    """Attach the low-precision smoother operator: blocks rounded to
    ``band_dtype`` + row-sum-consistent rebuilt pivots
    (:func:`consistent_pivots`).  One-time build work."""
    bet2, gam2 = consistent_pivots(pack, band_dtype)
    blocks_lp = tuple(b.astype(band_dtype) for b in pack.blocks)
    rb_lp = tuple(r.astype(band_dtype) for r in pack.rblocks) \
        if pack.real_matrix else None
    return pack._replace(lp=(blocks_lp, rb_lp, bet2, gam2))


def build_compact_pack(cA: jnp.ndarray, real_matrix: bool) -> CompactPack:
    """Pre-slice the extended band stack into the gather-block layout.

    One-time work per level (jit it with assembly); eliminates the per-call
    ``quad_ext_bands`` pass and its CUC-scale multi-GB HBM transient."""
    qa = [quad_ext_bands(cA[n]) for n in range(cA.shape[0])]
    blocks, rbs, ds, uds, bets, gams = [], [], [], [], [], []
    for (a, b) in _TKEYS:
        blocks.append(jnp.concatenate([
            _qread(qa[n - 1], a, b, bj, bi, bk)
            for (n, (bk, bj, bi)) in gather_keys(False)], axis=2))
        if real_matrix:
            rbs.append(jnp.concatenate([
                _qread(qa[n - 1], a, b, bj, bi, bk)[:1]
                for (n, (bk, bj, bi)) in real_only_keys()], axis=2))
        d = qa[0][(a, b)][:, 1:-1, 1:-1]
        ud = qa[1][(a, b)][1:, 1:-1, 1:-1]
        bet, gam = thomas_factor(d, ud)
        ds.append(d)
        uds.append(ud)
        bets.append(bet)
        gams.append(gam)
    return CompactPack(blocks=tuple(blocks), d=tuple(ds), ud=tuple(uds),
                       bet=tuple(bets), gam=tuple(gams),
                       real_matrix=real_matrix,
                       rblocks=tuple(rbs) if real_matrix else None)


def wide_slices(wide, nkeys: int) -> tuple:
    """The ``nkeys`` individual (nz, H, W) gather blocks of a
    x-concatenated wide array (nz, H, nkeys*W) — W-wide column slices
    (free in-kernel; fused by XLA outside)."""
    W = wide.shape[2] // nkeys
    return tuple(wide[:, :, m * W: (m + 1) * W] for m in range(nkeys))


def gather_blocks(e: Quads, blocks_t, a: int, b: int,
                  real_matrix: bool, k0=None) -> jnp.ndarray:
    """Off-column coupling sum for target quad (a, b) from persisted
    gather blocks — same term order (and bitwise result) as the reference
    gather (mg_relax.f90:263-300).  ``blocks_t`` is the tuple of
    per-key blocks (:func:`wide_slices` of the pack's wide array, or any
    equal-shaped views).

    The ``cmatrix='real'`` horizontal-diagonal couplings live on the k=1
    plane ONLY (mg_relax.f90:271-276), so they are evaluated on that one
    plane and summed into it by a leading-axis concat — 4 of the 16 terms
    on 1/64 of the depth instead of a full-depth masked pass (the level-0
    smoother's flop diet).  Values are bitwise the
    old ``s + k0*x`` form on plane 0 (multiply by 1.0 is exact) and on
    planes k>0 up to ``s + 0.0`` (identical except a signed-zero
    normalization).  ``k0`` is accepted for backward compatibility and
    ignored."""
    del k0
    keys = gather_keys(real_matrix)
    idx = {k: i for i, k in enumerate(keys)}

    def term(n, boff, poff, plane0=False):
        pk, pj, pi = poff
        blk = blocks_t[idx[(n, boff)]]
        st = _qread(e, a, b, pj, pi, pk)
        if plane0:
            return blk[:1] * st[:1]
        return blk * st

    s = None
    for n, boff, poff in _BASE_TERMS:
        t = term(n, boff, poff)
        s = t if s is None else s + t
    if real_matrix:
        x0 = None
        for n, boff, poff in _REAL_TERMS:
            t = term(n, boff, poff, plane0=True)    # pk == 0 for all four
            x0 = t if x0 is None else x0 + t
        s = jnp.concatenate([s[:1] + x0, s[1:]], axis=0)
    return s


def _line_solve(method: str, bet, gam, ud, d_fn, r) -> jnp.ndarray:
    """Exact z-line solve of the color update: 'pcr' is parallel cyclic
    reduction on the diagonal ``d_fn()``; otherwise the division-free
    substitution with precomputed pivots — bitwise the reference Thomas
    recurrence (ops/relax.thomas_factor)."""
    if method == "pcr":
        return tridiag_pcr(d_fn(), ud, r)
    return tridiag_factored(bet, gam, ud, r)


_RB_TARGETS = (((0, 0), (1, 1)),   # color 0: (i + j) even
               ((0, 1), (1, 0)))   # color 1: (i + j) odd
# FC reference order (mg_relax.f90:214-228): (i even, j even), (i even,
# j odd), (i odd, j even), (i odd, j odd) — quad key is (a, b) = (j%2, i%2)
_FC_TARGETS = (((0, 0),), ((1, 0),), ((0, 1),), ((1, 1),))


def relax_compact(p: jnp.ndarray, b: jnp.ndarray, cA: jnp.ndarray,
                  nsweeps: int, kind: str, real_matrix: bool,
                  tridiag_method: str = "thomas",
                  extend_fn=None, pack: CompactPack | None = None
                  ) -> jnp.ndarray:
    """``nsweeps`` RB (or FC) line-smoothing sweeps in quad-parity form.

    ``extend_fn`` maps the four quads to their halo-extended forms; the
    default is the single-shard physical-mirror rule (:func:`extend_quads`).
    The distributed backend passes a ppermute seam exchange
    (parallel/exchange.extend_quads_shard) — shard tiles must have even
    dims so local quad parity equals global parity.  Requires even ny, nx.

    ``pack`` is the persisted gather-block operator; if absent it is built
    here (one extra HBM pass, fine for tests / per-call shard_map use).
    """
    nz, ny, nx = p.shape
    assert ny % 2 == 0 and nx % 2 == 0, "compact relax needs even ny, nx"
    if pack is None:
        pack = build_compact_pack(cA, real_matrix)
    q = relax_compact_quads(split_quads(p), split_quads(b), pack, nsweeps,
                            kind, real_matrix,
                            tridiag_method=tridiag_method,
                            extend_fn=extend_fn)
    return merge_quads(q)


def relax_compact_quads(q0: Quads, bq: Quads, pack: CompactPack,
                        nsweeps: int, kind: str, real_matrix: bool,
                        tridiag_method: str = "thomas",
                        extend_fn=None) -> Quads:
    """Quad-native core of :func:`relax_compact`: state in, state out in
    quad-parity layout — no split/merge (the quad-persistent V-cycle path,
    solver.fcycle)."""
    extend = extend_fn or extend_quads
    targets_by_color = _RB_TARGETS if kind == "RB" else _FC_TARGETS
    ti = {t: i for i, t in enumerate(_TKEYS)}
    W = q0[(0, 0)].shape[2]

    nkeys = len(gather_keys(real_matrix))

    def color_update(q: Quads, targets) -> Quads:
        e = extend(q)
        # PCR keeps the f32 operator: it solves with pack.d directly, and
        # a rounded gather against the true diagonal would break the
        # row-sum consistency the lp build restores via rebuilt pivots
        lp_ok = tridiag_method != "pcr"
        ops_t = {t: smoother_operator(pack, ti[t]) if lp_ok
                 else (block_views(pack, ti[t]), pack.bet[ti[t]],
                       pack.gam[ti[t]])
                 for t in targets}
        rhs = [bq[t] - gather_blocks(
            e, ops_t[t][0], t[0], t[1],
            real_matrix) for t in targets]
        # concat target quads along x: one full-width tridiag solve
        cat = lambda f: jnp.concatenate([f[ti[t]] for t in targets], axis=-1)
        catp = lambda i: jnp.concatenate([ops_t[t][i] for t in targets],
                                         axis=-1)
        r = jnp.concatenate(rhs, axis=-1)
        sol = _line_solve(tridiag_method, catp(1), catp(2), cat(pack.ud),
                          lambda: cat(pack.d), r)
        q = dict(q)
        for n, t in enumerate(targets):
            q[t] = sol[..., n * W:(n + 1) * W]
        return q

    def sweep(q):
        for targets in targets_by_color:
            q = color_update(q, targets)
        return q

    keys = sorted(q0)
    if nsweeps <= 1:
        q = dict(q0)
        for _ in range(nsweeps):
            q = sweep(q)
        return q

    def body(i, flat):
        q = sweep(dict(zip(keys, flat)))
        return tuple(q[k] for k in keys)

    flat = jax.lax.fori_loop(0, nsweeps, body,
                             tuple(q0[k] for k in keys))
    return dict(zip(keys, flat))


def _residual_one_core(e: Quads, bq_t, d, ud, blocks_t,
                       t: Tuple[int, int], real_matrix: bool
                       ) -> jnp.ndarray:
    """Fresh residual of ONE target quad from the extended state ``e`` —
    the per-target body of :func:`residual_quads` (exact expression
    order; every fused/partial residual path must reproduce it bitwise).
    All operands may be consistently row/col-sliced sub-boxes
    (:func:`_residual_box`): slicing commutes with every term."""
    pq = e[t][:, 1:-1, 1:-1]
    z1 = jnp.zeros_like(ud[:1])
    lo2 = jnp.concatenate([z1, ud], axis=0)   # cA2(k),   couples p(k-1)
    hi2 = jnp.concatenate([ud, z1], axis=0)   # cA2(k+1), couples p(k+1)
    return (bq_t
            - d * pq
            - lo2 * _kshift(pq, -1)
            - hi2 * _kshift(pq, 1)
            - gather_blocks(e, blocks_t, t[0], t[1], real_matrix))


def _residual_one(e: Quads, bq_t, pack: CompactPack, m: int,
                  t: Tuple[int, int], real_matrix: bool) -> jnp.ndarray:
    return _residual_one_core(e, bq_t, pack.d[m], pack.ud[m],
                              block_views(pack, m), t, real_matrix)


def _residual_box(e: Quads, bq_t, pack: CompactPack, m: int,
                  t: Tuple[int, int], real_matrix: bool,
                  jsl: slice = slice(None), isl: slice = slice(None)
                  ) -> jnp.ndarray:
    """Fresh residual restricted to quad rows ``jsl`` x cols ``isl`` —
    every operand sliced consistently, then the exact
    :func:`_residual_one_core` expression (bitwise-equal to slicing the
    full fresh residual)."""
    def ext(s):
        # output rows [start, stop) read extended rows [start, stop + 2)
        # (extended index = quad row + 1, stencil offsets in {-1, 0, 1})
        return slice(None) if s == slice(None) \
            else slice(s.start, s.stop + 2)

    e_sub = {k: x[:, ext(jsl), ext(isl)] for k, x in e.items()}
    blocks = tuple(blk[:, jsl, isl] for blk in block_views(pack, m))
    return _residual_one_core(e_sub, bq_t[:, jsl, isl],
                              pack.d[m][:, jsl, isl],
                              pack.ud[m][:, jsl, isl],
                              blocks, t, real_matrix)


def residual_from_gather(bq_t, sol, pack: CompactPack, m: int,
                         g) -> jnp.ndarray:
    """Residual of a just-updated target from its own color update's
    gather value ``g``: the exact line solve leaves r = b - D x - g with
    the SAME ``g`` the solve consumed, and for the LAST color of a sweep
    the base-term gather state (opposite-color quads) does not change
    afterwards — so this equals the fresh residual bitwise, except
    through the ``cmatrix='real'`` plane-0 diagonal couplings (same-color
    reads, patched by :func:`_residual_plane0`).  Same expression order
    as :func:`_residual_one`."""
    ud = pack.ud[m]
    z1 = jnp.zeros_like(ud[:1])
    lo2 = jnp.concatenate([z1, ud], axis=0)
    hi2 = jnp.concatenate([ud, z1], axis=0)
    return (bq_t
            - pack.d[m] * sol
            - lo2 * _kshift(sol, -1)
            - hi2 * _kshift(sol, 1)
            - g)


def _plane0_of_kshift(x, pk: int):
    """Plane-0 row of ``_kshift(x, pk)`` without materializing the shift."""
    if pk == 0:
        return x[:1]
    if pk == 1:
        return x[1:2]
    return jnp.zeros_like(x[:1])


def _residual_plane0(e: Quads, bq_t, pack: CompactPack, m: int,
                     t: Tuple[int, int], real_matrix: bool) -> jnp.ndarray:
    """Plane-0 row of :func:`_residual_one` computed on plane slices, term
    for term in the same association order (bitwise-equal to slicing the
    full fresh residual).  Used to patch the ``cmatrix='real'`` diagonal
    couplings of a fused last-color residual: they read the SAME-color
    sibling quad, whose post-update values the in-sweep gather predates."""
    a, b = t
    keys = gather_keys(real_matrix)
    idx = {k: i for i, k in enumerate(keys)}
    blocks_t = block_views(pack, m)

    def term0(n, boff, poff):
        pk, pj, pi = poff
        a2, b2 = (a + pj) % 2, (b + pi) % 2
        rj = (a + pj - a2) // 2
        ri = (b + pi - b2) // 2
        x = e[(a2, b2)]
        H, W = x.shape[-2] - 2, x.shape[-1] - 2
        st = _plane0_of_kshift(x[:, 1 + rj:1 + rj + H, 1 + ri:1 + ri + W],
                               pk)
        return blocks_t[idx[(n, boff)]][:1] * st

    g0 = None
    for n, boff, poff in _BASE_TERMS:
        v = term0(n, boff, poff)
        g0 = v if g0 is None else g0 + v
    if real_matrix:
        x0 = None
        for n, boff, poff in _REAL_TERMS:
            v = term0(n, boff, poff)
            x0 = v if x0 is None else x0 + v
        g0 = g0 + x0
    pq = e[t][:, 1:-1, 1:-1]
    ud = pack.ud[m]
    z0 = jnp.zeros_like(bq_t[:1])
    # lo2[0] = 0 and _kshift(pq,-1)[0] = 0 -> the term is an exact +0.0,
    # and x - (+0.0) is the bitwise identity for every x incl. -0.0
    return (bq_t[:1]
            - pack.d[m][:1] * pq[:1]
            - z0
            - ud[:1] * pq[1:2]
            - g0)


def residual_quads(q: Quads, bq: Quads, pack: CompactPack,
                   real_matrix: bool, extend_fn=None,
                   targets=None) -> Quads:
    """r = b - A p with state and result in quad-parity layout.

    Term for term (and bitwise) ops/stencil.residual in quad form: the same
    gather order, the same in-column diagonal/vertical handling (zero-padded
    k-shifts).  Shared by the quad-persistent V-cycle's XLA fallback and
    mirrored by the Pallas kernel's emitted residual.  ``targets``
    restricts the
    output to a subset of quads (the fused-residual path computes the
    last-updated color in-sweep and only the other color fresh)."""
    e = (extend_fn or extend_quads)(q)
    ti = {t: i for i, t in enumerate(_TKEYS)}
    out = {}
    for t in (targets if targets is not None else _TKEYS):
        out[t] = _residual_one(e, bq[t], pack, ti[t], t, real_matrix)
    return out


def _patch_emitted_residual(e2: Quads, bq_t, pack: CompactPack, m: int,
                            t: Tuple[int, int], real_matrix: bool,
                            r) -> jnp.ndarray:
    """Make an emitted last-color residual bitwise-FRESH.

    Two places where the in-sweep gather differs from a fresh one:
      1. Boundary ring — the Neumann mirror halo reflects the target's
         own color, so the solve consumed PRE-update mirror values.
         Exactly one quad row (j = -1 side for a = 0, j = ny side for
         a = 1) and one quad column (by b) per target; both are
         recomputed fresh (:func:`_residual_box`).
      2. ``cmatrix='real'`` plane-0 diagonal couplings read the
         same-color sibling — the whole plane 0 is recomputed fresh
         (:func:`_residual_plane0`).
    """
    a, b = t
    H, W = r.shape[1], r.shape[2]
    J = 0 if a == 0 else H - 1
    Ic = 0 if b == 0 else W - 1
    row = _residual_box(e2, bq_t, pack, m, t, real_matrix,
                        jsl=slice(J, J + 1))
    col = _residual_box(e2, bq_t, pack, m, t, real_matrix,
                        isl=slice(Ic, Ic + 1))
    # assemble in ONE nested-concat expression (a single output write;
    # three sequential full-array patch copies measurably ate the fused
    # residual's savings at CUC scale)
    cat = lambda parts, ax: jnp.concatenate(
        [x for x in parts if x.shape[ax]], axis=ax)

    def with_patches(rr, rowp, colp):
        """rows J <- rowp, cols Ic <- colp (col wins only off row J),
        everything else rr."""
        others = cat((rr[:, :J], rr[:, J + 1:]), 1)
        colp_o = cat((colp[:, :J], colp[:, J + 1:]), 1)
        others = cat((others[:, :, :Ic], colp_o, others[:, :, Ic + 1:]), 2)
        if J == 0:
            return cat((rowp, others), 1)
        return cat((others, rowp), 1)

    if real_matrix:
        p0 = _residual_plane0(e2, bq_t, pack, m, t, real_matrix)
        body = with_patches(r[1:], row[1:], col[1:])
        return jnp.concatenate([p0, body], axis=0)
    return with_patches(r, row, col)


def _patched_zsum(e2: Quads, bq_t, pack: CompactPack, m: int,
                  t: Tuple[int, int], real_matrix: bool, r) -> jnp.ndarray:
    """z-pair sums of a patched emitted residual, with the patches applied
    AFTER the z-sum — half the patch-concat traffic of
    ``zsum(_patch_emitted_residual(...))``.  Same values in exact
    arithmetic: every patched entry is the fresh-residual expression
    either way (ring rows/cols fully fresh; plane-0 pair = fresh plane 0
    + raw plane 1)."""
    a, b = t
    H, W = r.shape[1], r.shape[2]
    J = 0 if a == 0 else H - 1
    Ic = 0 if b == 0 else W - 1
    zs = r[0::2] + r[1::2]
    if real_matrix:
        p0 = _residual_plane0(e2, bq_t, pack, m, t, real_matrix)
        zs = jnp.concatenate([p0 + r[1:2], zs[1:]], axis=0)
    row = _residual_box(e2, bq_t, pack, m, t, real_matrix,
                        jsl=slice(J, J + 1))
    zs = jnp.concatenate(
        [x for x in (zs[:, :J], row[0::2] + row[1::2], zs[:, J + 1:])
         if x.shape[1]], axis=1)
    col = _residual_box(e2, bq_t, pack, m, t, real_matrix,
                        isl=slice(Ic, Ic + 1))
    zs = jnp.concatenate(
        [x for x in (zs[:, :, :Ic], col[0::2] + col[1::2],
                     zs[:, :, Ic + 1:]) if x.shape[2]], axis=2)
    return zs


def relax_emit_last_color(q0: Quads, bq: Quads, pack: CompactPack,
                          nsweeps: int, real_matrix: bool,
                          tridiag_method: str = "thomas",
                          extend_fn=None, sweep_fn=None,
                          color_update_fn=None):
    """``nsweeps`` RB sweeps with the LAST color update also emitting its
    targets' residuals from its own gather: an exact line solve leaves
    r = b - Dx - g with the solve's own ``g``, and the base-term state it
    read (opposite-color quads) does not change after the last color —
    so the emitted residual equals a fresh one, except through the
    boundary mirror ring and the ``cmatrix='real'`` plane-0 same-color
    couplings (callers patch both with
    :func:`_patch_emitted_residual`).

    Returns ``(q, info)`` — the post-sweep state and
    ``{target: raw residual}`` for the last color's targets.

    ``sweep_fn(q, n)`` runs the first ``nsweeps - 1`` full sweeps
    (default: the XLA compact path); ``color_update_fn(q, targets, emit)
    -> (q, info)`` substitutes the per-color update (the Pallas kernel
    path).  Peeling the last sweep is arithmetic-neutral: the per-sweep
    ops are identical in and out of the fori_loop."""
    assert nsweeps >= 1, "fused relax+residual needs at least one sweep"
    extend = extend_fn or extend_quads
    ti = {t: i for i, t in enumerate(_TKEYS)}
    nkeys = len(gather_keys(real_matrix))
    W = q0[(0, 0)].shape[2]

    if sweep_fn is None:
        sweep_fn = lambda q, n: relax_compact_quads(
            q, bq, pack, n, "RB", real_matrix,
            tridiag_method=tridiag_method, extend_fn=extend_fn)
    q = dict(sweep_fn(q0, nsweeps - 1)) if nsweeps > 1 else dict(q0)

    def xla_color_update(q, targets, emit):
        """The exact relax_compact_quads color update (concatenated
        tridiag solve), optionally emitting each target's residual from
        the in-sweep gather."""
        e = extend(q)
        gs = {t: gather_blocks(e, block_views(pack, ti[t]),
                               t[0], t[1], real_matrix) for t in targets}
        rhs = [bq[t] - gs[t] for t in targets]
        cat = lambda f: jnp.concatenate([f[ti[t]] for t in targets],
                                        axis=-1)
        r = jnp.concatenate(rhs, axis=-1)
        sol = _line_solve(tridiag_method, cat(pack.bet), cat(pack.gam),
                          cat(pack.ud), lambda: cat(pack.d), r)
        q = dict(q)
        info = {}
        for n, t in enumerate(targets):
            q[t] = sol[..., n * W:(n + 1) * W]
            if emit:
                info[t] = residual_from_gather(bq[t], q[t], pack, ti[t],
                                               gs[t])
        return q, info

    update = color_update_fn or xla_color_update
    q, _ = update(q, _RB_TARGETS[0], False)
    q, info = update(q, _RB_TARGETS[1], True)
    return q, info


def relax_residual_compact_quads(q0: Quads, bq: Quads, pack: CompactPack,
                                 nsweeps: int, real_matrix: bool,
                                 tridiag_method: str = "thomas",
                                 extend_fn=None, sweep_fn=None,
                                 color_update_fn=None):
    """``nsweeps`` RB sweeps PLUS the fresh post-sweep residual, the last
    color's residual coming from its own color update instead of a second
    full gather pass.  Returns ``(q, rq)``, both dicts over _TKEYS;
    equal to ``relax_compact_quads`` followed by :func:`residual_quads`
    in exact arithmetic (~1 ulp of XLA recompilation noise across the
    peeled final sweep; exact for nsweeps == 1)."""
    extend = extend_fn or extend_quads
    ti = {t: i for i, t in enumerate(_TKEYS)}
    q, info = relax_emit_last_color(
        q0, bq, pack, nsweeps, real_matrix,
        tridiag_method=tridiag_method, extend_fn=extend_fn,
        sweep_fn=sweep_fn, color_update_fn=color_update_fn)
    # fresh residual for the first color (its neighbours changed in the
    # second color's update) + the patched emitted last-color residuals
    e2 = extend(q)
    rq = {}
    for t in _RB_TARGETS[0]:
        rq[t] = _residual_one(e2, bq[t], pack, ti[t], t, real_matrix)
    for t in _RB_TARGETS[1]:
        rq[t] = _patch_emitted_residual(e2, bq[t], pack, ti[t], t,
                                        real_matrix, info[t])
    return q, rq


def relax_residual_restrict_compact_quads(q0: Quads, bq: Quads,
                                          pack: CompactPack, nsweeps: int,
                                          real_matrix: bool,
                                          tridiag_method: str = "thomas",
                                          extend_fn=None, sweep_fn=None,
                                          color_update_fn=None,
                                          rr_fn=None):
    """``nsweeps`` RB sweeps PLUS the coarse RHS restrict(b - A p) — the
    V-cycle down-leg pair with the last color's residual fused into its
    color update.  Returns ``(q, coarse_b)`` with ``coarse_b`` the FULL
    coarse array; equal in exact arithmetic to relax then
    residual_restrict (the
    z-pair/i-j summation tree matches transfer.restrict_3d).

    ``rr_fn(e4, t) -> (nz/2, H, W)`` optionally computes a fresh target's
    residual z-pair sums (the tiled `_rr_one` kernel); default derives
    them from the XLA fresh residual.  Equal to the two-call form in
    exact arithmetic (see :func:`relax_residual_compact_quads`)."""
    extend = extend_fn or extend_quads
    ti = {t: i for i, t in enumerate(_TKEYS)}
    q, info = relax_emit_last_color(
        q0, bq, pack, nsweeps, real_matrix,
        tridiag_method=tridiag_method, extend_fn=extend_fn,
        sweep_fn=sweep_fn, color_update_fn=color_update_fn)
    e2 = extend(q)
    zsum = lambda r: r[0::2] + r[1::2]
    zs = {}
    for t in _RB_TARGETS[0]:
        if rr_fn is not None:
            zs[t] = rr_fn(e2, t)
        else:
            zs[t] = zsum(_residual_one(e2, bq[t], pack, ti[t], t,
                                       real_matrix))
    for t in _RB_TARGETS[1]:
        zs[t] = _patched_zsum(e2, bq[t], pack, ti[t], t, real_matrix,
                              info[t])
    return q, ((zs[(0, 0)] + zs[(1, 0)]) + (zs[(0, 1)] + zs[(1, 1)]))


def restrict_quads_to_full(rq: Quads) -> jnp.ndarray:
    """Coarse = sum of 8 children with the residual given in quads — the
    exact summation tree of transfer.restrict_3d (z-pairs, then j-pairs,
    then i-pairs) for identical rounding."""
    t1 = {t: rq[t][0::2] + rq[t][1::2] for t in _TKEYS}
    return (t1[(0, 0)] + t1[(1, 0)]) + (t1[(0, 1)] + t1[(1, 1)])
