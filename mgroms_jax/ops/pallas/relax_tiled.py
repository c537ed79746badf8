"""Pallas color update through Triton — the compact smoother's GPU kernel.

One red-black color update of one target quad is the 12-16 term neighbour
gather, the tridiagonal right-hand side, and the exact z-line solve with
the precomputed pivots of ops/relax.thomas_factor (mg_relax.f90:237-334).
The XLA form (ops/relax_compact.relax_compact_quads) solves the z-lines
with two ``lax.scan``s of nz-1 steps, and on a GPU every scan step is at
least one launch over a whole (H, W) plane.

Here one program owns a (tj, tw) tile of quad columns and walks z inside
the program.  The forward loop reads plane k of the gather blocks, the
three sibling quads at k-1, k and k+1, ``b``, ``bet`` and ``ud``, keeps
x_{k-1} in registers and stores x_k; the backward loop re-reads the stored
planes and applies ``x_k -= gam_k x_{k+1}`` with ``gam = ud*bet``
recomputed (bitwise the precomputed factor).  Every operator byte crosses
device
memory once per update.  Tiles are powers of two; rows and columns past
the quad's edge are masked, so any (H, W) works without padding copies.

Halos come from the caller's extension (ops/relax_compact.extend_quads, or
the ppermute seam exchange under shard_map): the kernel reads the three
extended sibling quads (nz, H+2, W+2) at shifted offsets.  The emitting
variant also writes the target's residual from its own gather
(relax_compact.residual_from_gather, same expression order) for the
fused relax+residual down-leg (cfg.fused_residual).

The kernel serves float32 state with float32 or bfloat16 (pack.lp) gather
blocks; float64 solves stay on XLA (platform.kernel_allowed).  With
``interpret=True`` the same kernel runs in the Pallas interpreter on any
backend — that is how the CPU tests cover it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..relax_compact import (_BASE_TERMS, _FC_TARGETS, _RB_TARGETS,
                             _REAL_TERMS, _TKEYS, CompactPack,
                             build_compact_pack, extend_quads, gather_keys,
                             merge_quads, split_quads)

# columns per program (a power of two) and warps per program; not tuned
# on the card yet (PERF.md, Open questions)
TILE_ELEMS = 512
NUM_WARPS = 4


def pick_tile(H: int, W: int) -> tuple:
    """(tj, tw) tile of quad columns: tw the next power of two above W, at
    most 128; tj the rest of TILE_ELEMS, at most the next power of two
    above H."""
    tw = min(128, pl.next_power_of_2(W))
    tj = max(1, min(TILE_ELEMS // tw, pl.next_power_of_2(H)))
    return tj, tw


def _gather_quads(target) -> tuple:
    """The 3 quads the neighbour gather for ``target`` reads: the
    y-sibling, the x-sibling and the diagonal sibling.  The target's OWN
    quad never appears (every off-column coupling flips at least one
    parity)."""
    a, b = target
    return ((1 - a) % 2, b), (a, (1 - b) % 2), ((1 - a) % 2, (1 - b) % 2)


def _kernel(*refs, target, real_matrix, nkeys, nz, H, W, tj, tw, emit):
    a, b = target
    e_refs = dict(zip(_gather_quads(target), refs[:3]))
    wide_ref = refs[3]
    n = 4
    rb_ref = None
    if real_matrix:
        rb_ref = refs[4]
        n = 5
    if emit:
        ud_ref, bet_ref, d_ref, bq_ref, out_ref, res_ref = refs[n:]
    else:
        ud_ref, bet_ref, bq_ref, out_ref = refs[n:]
    dt = out_ref.dtype
    j0 = pl.program_id(0) * tj
    i0 = pl.program_id(1) * tw
    rows = j0 + jnp.arange(tj, dtype=jnp.int32)[:, None]
    cols = i0 + jnp.arange(tw, dtype=jnp.int32)[None, :]
    mask = (rows < H) & (cols < W)
    zero = jnp.zeros((tj, tw), dt)

    # indices stay int32 (python ints would trace as int64 under
    # jax_enable_x64)
    i32 = lambda v: jnp.asarray(v, jnp.int32)

    def ld(ref, k, r0, c0):
        v = plgpu.load(
            ref.at[i32(k), pl.ds(i32(r0), tj), pl.ds(i32(c0), tw)],
            mask=mask, other=0)
        return v.astype(dt)

    def st(ref, k, v):
        plgpu.store(ref.at[i32(k), pl.ds(j0, tj), pl.ds(i0, tw)], v,
                    mask=mask)

    idx = {key: i for i, key in enumerate(gather_keys(real_matrix))}

    def block(key, k):
        m = idx[key]
        if m < nkeys:
            return ld(wide_ref, k, j0, m * W + i0)
        return ld(rb_ref, 0, j0, (m - nkeys) * W + i0)

    def state(k, poff):
        """State at offset (pk, pj, pi) of the target columns on plane k:
        one shifted read of the sibling quad (relax_compact._qread), zero
        outside [0, nz) (the zero-padded k-shift)."""
        pk, pj, pi = poff
        a2, b2 = (a + pj) % 2, (b + pi) % 2
        rj = (a + pj - a2) // 2
        ri = (b + pi - b2) // 2
        kk = k + pk
        v = ld(e_refs[(a2, b2)], jnp.clip(kk, 0, nz - 1),
               j0 + 1 + rj, i0 + 1 + ri)
        if pk == 0:
            return v
        return jnp.where((kk >= 0) & (kk < nz), v, zero)

    def gather(k):
        """Off-column coupling sum on plane k — relax_compact.gather_blocks
        term for term, in its summation order."""
        s = None
        for nb, boff, poff in _BASE_TERMS:
            t = block((nb, boff), k) * state(k, poff)
            s = t if s is None else s + t
        return s

    def gather0():
        s = gather(0)
        if real_matrix:
            x0 = None
            for nb, boff, poff in _REAL_TERMS:
                t = block((nb, boff), 0) * state(0, poff)
                x0 = t if x0 is None else x0 + t
            s = s + x0
        return s

    # forward substitution: x_k = (rhs_k - ud_{k-1} x_{k-1}) * bet_k
    g = gather0()
    if emit:
        st(res_ref, 0, g)
    x = (ld(bq_ref, 0, j0, i0) - g) * ld(bet_ref, 0, j0, i0)
    st(out_ref, 0, x)

    def fwd(k, xprev):
        g = gather(k)
        if emit:
            st(res_ref, k, g)
        rhs = ld(bq_ref, k, j0, i0) - g
        xk = (rhs - ld(ud_ref, k - 1, j0, i0) * xprev) * ld(bet_ref, k, j0,
                                                            i0)
        st(out_ref, k, xk)
        return xk

    x = jax.lax.fori_loop(jnp.int32(1), jnp.int32(nz), fwd, x)

    def residual(k, xm, xk, xp, lo, hi):
        """relax_compact.residual_from_gather on plane k (g was parked in
        res_ref by the forward loop)."""
        r = (ld(bq_ref, k, j0, i0)
             - ld(d_ref, k, j0, i0) * xk
             - lo * xm
             - hi * xp
             - ld(res_ref, k, j0, i0))
        st(res_ref, k, r)

    # backward substitution: x_k -= (ud_k bet_k) x_{k+1}; the emitting
    # variant writes plane k+1's residual once x_k is final
    def bwd(i, carry):
        xk1, xk2 = carry                       # final x_{k+1}, x_{k+2}
        k = nz - 2 - i
        udk = ld(ud_ref, k, j0, i0)
        xk = ld(out_ref, k, j0, i0) - (udk * ld(bet_ref, k, j0, i0)) * xk1
        st(out_ref, k, xk)
        if emit:
            hi = jnp.where(k + 1 < nz - 1,
                           ld(ud_ref, jnp.minimum(k + 1, nz - 2), j0, i0),
                           zero)
            residual(k + 1, xk, xk1, xk2, udk, hi)
        return xk, xk1

    x0, x1 = jax.lax.fori_loop(jnp.int32(0), jnp.int32(nz - 1), bwd,
                               (x, zero))
    if emit:
        hi = ld(ud_ref, 0, j0, i0) if nz > 1 else zero
        residual(0, zero, x0, x1, zero, hi)


@functools.partial(jax.jit, static_argnames=("target", "real_matrix",
                                             "interpret", "tile"))
def color_update_tiled(e3: tuple, bq_t: jnp.ndarray, blocks_w, ud_t, bet_t,
                       target, real_matrix: bool, interpret: bool = False,
                       rb_t=None, d_t=None, tile=None):
    """Update ONE target quad.  ``e3``: the three extended sibling quads
    (nz, H+2, W+2) in ``_gather_quads(target)`` order; ``bq_t`` (nz, H, W)
    the target's RHS quad; ``blocks_w`` the wide x-concatenated gather
    blocks (nz, H, nkeys*W), float32 or the bfloat16 lp copy; ``ud_t``,
    ``bet_t`` the target's pack fields; ``rb_t`` the single-plane
    real-only pair (1, H, 2W).  Returns the new quad (nz, H, W).

    With ``d_t`` (the in-column diagonal) the kernel also emits the
    target's residual from its own gather and returns ``(quad, residual)``;
    the residual's boundary ring and 'real' plane-0 couplings still
    reflect pre-update same-color values (the caller patches them,
    relax_compact._patch_emitted_residual).  ``tile`` overrides the
    (tj, tw) column tile."""
    nz, H, W = bq_t.shape
    nkeys = len(gather_keys(False))
    tj, tw = tile or pick_tile(H, W)
    emit = d_t is not None
    kern = functools.partial(_kernel, target=target,
                             real_matrix=real_matrix, nkeys=nkeys, nz=nz,
                             H=H, W=W, tj=tj, tw=tw, emit=emit)
    shape = jax.ShapeDtypeStruct((nz, H, W), bq_t.dtype)
    ins = [*e3, blocks_w] + ([rb_t] if real_matrix else []) \
        + [ud_t, bet_t] + ([d_t] if emit else []) + [bq_t]
    return pl.pallas_call(
        kern,
        out_shape=(shape, shape) if emit else shape,
        grid=(pl.cdiv(H, tj), pl.cdiv(W, tw)),
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(NUM_WARPS, tj * tw // 128))),
        name=f"color_update_q{target[0]}{target[1]}"
             + ("_emit" if emit else ""),
    )(*ins)


def relax_compact_tiled(p: jnp.ndarray, b: jnp.ndarray, pack: CompactPack,
                        nsweeps: int, kind: str, real_matrix: bool,
                        interpret: bool = False, cA=None,
                        extend_fn=None) -> jnp.ndarray:
    """``nsweeps`` RB/FC sweeps with the kernel per (color, target quad),
    full arrays in and out.  Same iterates as ops/relax_compact.
    relax_compact (the kernel reuses its gather order and factored Thomas
    on the same persisted pack)."""
    if pack is None:
        assert cA is not None, "need a CompactPack or the band stack"
        pack = build_compact_pack(cA, real_matrix)
    q = relax_compact_tiled_quads(split_quads(p), split_quads(b), pack,
                                  nsweeps, kind, real_matrix,
                                  interpret=interpret, extend_fn=extend_fn)
    return merge_quads(q)


def _target_operator(pack: CompactPack, m: int, real_matrix: bool):
    """(blocks, rblocks, bet) the smoother reads for target ``m``: the
    low-precision copies when the pack carries them (cfg.fused_bands_bf16),
    else the float32 operator."""
    if pack.lp is not None:
        return (pack.lp[0][m], pack.lp[1][m] if real_matrix else None,
                pack.lp[2][m])
    return (pack.blocks[m], pack.rblocks[m] if real_matrix else None,
            pack.bet[m])


def relax_compact_tiled_quads(q0, bq, pack: CompactPack, nsweeps: int,
                              kind: str, real_matrix: bool,
                              interpret: bool = False, extend_fn=None):
    """Quad-native core of :func:`relax_compact_tiled` (state in and out in
    quad-parity layout — the quad-persistent V-cycle path).  Halo
    extension between colors stays in XLA; both targets of a color read
    the same pre-color extension."""
    extend = extend_fn or extend_quads
    targets_by_color = _RB_TARGETS if kind == "RB" else _FC_TARGETS
    ti = {t: i for i, t in enumerate(_TKEYS)}

    def color_update(q, targets):
        e = extend(q)
        q = dict(q)
        for t in targets:
            m = ti[t]
            blocks_m, rb_m, bet_m = _target_operator(pack, m, real_matrix)
            q[t] = color_update_tiled(
                tuple(e[k] for k in _gather_quads(t)), bq[t], blocks_m,
                pack.ud[m], bet_m, t, real_matrix, interpret=interpret,
                rb_t=rb_m)
        return q

    def sweep(q):
        for targets in targets_by_color:
            q = color_update(q, targets)
        return q

    if nsweeps <= 1:
        q = dict(q0)
        for _ in range(nsweeps):
            q = sweep(q)
        return q

    def body(i, flat):
        q = sweep(dict(zip(_TKEYS, flat)))
        return tuple(q[k] for k in _TKEYS)

    flat = jax.lax.fori_loop(0, nsweeps, body, tuple(q0[k] for k in _TKEYS))
    return dict(zip(_TKEYS, flat))


def _kernel_fused_parts(bq, pack, real_matrix, interpret, extend_fn):
    """The kernel's sweep_fn / color_update_fn, plugged into the
    relax_compact fused-residual orchestrators."""
    ti = {t: i for i, t in enumerate(_TKEYS)}
    extend = extend_fn or extend_quads

    def sweep_fn(q, n):
        return relax_compact_tiled_quads(q, bq, pack, n, "RB", real_matrix,
                                         interpret=interpret,
                                         extend_fn=extend_fn)

    def color_update(q, targets, emit):
        e = extend(q)
        q = dict(q)
        info = {}
        for t in targets:
            m = ti[t]
            e3 = tuple(e[k] for k in _gather_quads(t))
            rb = pack.rblocks[m] if real_matrix else None
            out = color_update_tiled(
                e3, bq[t], pack.blocks[m], pack.ud[m], pack.bet[m], t,
                real_matrix, interpret=interpret, rb_t=rb,
                d_t=pack.d[m] if emit else None)
            if emit:
                q[t], info[t] = out
            else:
                q[t] = out
        return q, info

    return sweep_fn, color_update


def relax_residual_tiled_quads(q0, bq, pack: CompactPack, nsweeps: int,
                               real_matrix: bool, interpret: bool = False,
                               extend_fn=None):
    """Kernel form of relax_compact.relax_residual_compact_quads:
    ``nsweeps`` RB sweeps + the fresh residual, the last color's residual
    emitted by the kernel and the first color's computed fresh (XLA quad
    form).  Returns (q, rq)."""
    from ..relax_compact import relax_residual_compact_quads
    sweep_fn, color_update = _kernel_fused_parts(
        bq, pack, real_matrix, interpret, extend_fn)
    return relax_residual_compact_quads(
        q0, bq, pack, nsweeps, real_matrix, extend_fn=extend_fn,
        sweep_fn=sweep_fn, color_update_fn=color_update)


def relax_residual_restrict_tiled_quads(q0, bq, pack: CompactPack,
                                        nsweeps: int, real_matrix: bool,
                                        interpret: bool = False,
                                        extend_fn=None):
    """Kernel form of the fused V-cycle down-leg: ``nsweeps`` RB sweeps +
    restrict(b - A p), the last color's residual from the kernel, the
    first color's fresh residual and the restriction in XLA.  Returns
    (q, coarse_b)."""
    from ..relax_compact import relax_residual_restrict_compact_quads
    sweep_fn, color_update = _kernel_fused_parts(
        bq, pack, real_matrix, interpret, extend_fn)
    return relax_residual_restrict_compact_quads(
        q0, bq, pack, nsweeps, real_matrix, extend_fn=extend_fn,
        sweep_fn=sweep_fn, color_update_fn=color_update)
