"""Line relaxation: red-black (and GS/four-color) z-line smoothing.

JAX port of the reference's hot kernel (src/mg_relax.f90:16-334).
Per colored column (i, j) the reference gathers the 12-16 off-column
couplings into a tridiagonal system in z and Thomas-solves it exactly
(``relax_3D_8_heart`` :237-305 + ``tridiag`` :308-334).

Vectorization strategy: instead of looping over columns, we build the
tridiagonal RHS for *every* column at once (one fused stencil kernel, see
ops/stencil.offdiag_columns), Thomas-solve all columns simultaneously with a
``lax.scan`` over z (each scan step is an elementwise (ny, nx) op), and
commit only the active color with a parity mask.  The halo refresh after
every color (mg_relax.f90:181 — the protocol that fixes the reference's
convergence factor) is preserved: ``extend_fn`` is called per color.

Exactness notes:
  - 'RB' / 'FC': within a color, columns couple only through the bottom-level
    ``cmatrix='real'`` diagonal terms ('RB') or not at all ('FC').  The
    reference sweeps columns in i-then-j order, so its RB pass consumes
    same-sweep values through those few k=1 diagonal couplings; the
    vectorized simultaneous update uses pre-color values there instead.
    'FC' is a proper coloring of the stencil graph and is order-exact.
  - 'GS' in the reference is a sequential in-place sweep (order-dependent);
    here it becomes a simultaneous column-Jacobi sweep.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from .stencil import band, offdiag_columns

ExtendFn = Callable[[jnp.ndarray], jnp.ndarray]


def tridiag_pcr(d: jnp.ndarray, dd: jnp.ndarray, b: jnp.ndarray
                ) -> jnp.ndarray:
    """Parallel cyclic reduction solve of the same symmetric tridiagonal
    systems as :func:`tridiag` — exact in exact arithmetic, but built from
    ceil(log2(nz)) full-width vector steps instead of 2*nz sequential scan
    steps (a vector-friendly alternative to the reference's Thomas loop,
    mg_relax.f90:308-334)."""
    nz = d.shape[0]
    if nz == 1:
        return b / d
    lo = jnp.concatenate([jnp.zeros_like(dd[:1]), dd], axis=0)   # a_k
    up = jnp.concatenate([dd, jnp.zeros_like(dd[:1])], axis=0)   # c_k
    diag = d
    rhs = b
    s = 1
    while s < nz:
        def shdn(x, fill=0.0):   # x_{k-s}
            pad = jnp.full_like(x[:s], fill)
            return jnp.concatenate([pad, x[:-s]], axis=0)

        def shup(x, fill=0.0):   # x_{k+s}
            pad = jnp.full_like(x[:s], fill)
            return jnp.concatenate([x[s:], pad], axis=0)

        alpha = -lo / shdn(diag, 1.0)
        gamma = -up / shup(diag, 1.0)
        diag = diag + alpha * shdn(up) + gamma * shup(lo)
        rhs = rhs + alpha * shdn(rhs) + gamma * shup(rhs)
        lo = alpha * shdn(lo)
        up = gamma * shup(up)
        s *= 2
    return rhs / diag


def thomas_factor(d: jnp.ndarray, ud: jnp.ndarray):
    """Precompute the Thomas pivots: ``bet`` (the reciprocal pivots, nz)
    and ``gam`` (the back-substitution multipliers, nz-1).

    These depend only on the operator's in-column tridiagonal (d, ud) —
    constant across sweeps and cycles — so the smoother's hot path never
    divides: :func:`tridiag_factored` is pure multiply-add.  The recurrence
    is the exact op order of :func:`tridiag` (mg_relax.f90:308-334), so
    factored solves are bitwise-equal to the reference Thomas.
    """
    nz = d.shape[0]
    bet0 = 1.0 / d[0]
    if nz == 1:
        return bet0[None], jnp.zeros_like(d[:0])

    def fwd(bet, inp):
        dk, ddm = inp
        gam = ddm * bet
        bet = 1.0 / (dk - ddm * gam)
        return bet, (gam, bet)

    _, (gams, bets) = jax.lax.scan(fwd, bet0, (d[1:], ud))
    return jnp.concatenate([bet0[None], bets], axis=0), gams


def tridiag_factored(bet: jnp.ndarray, gam: jnp.ndarray, ud: jnp.ndarray,
                     b: jnp.ndarray) -> jnp.ndarray:
    """Thomas substitution with precomputed pivots (:func:`thomas_factor`):
    forward x_k = (b_k - ud_{k-1} x_{k-1}) * bet_k, backward
    x_k -= gam_k x_{k+1}.  No divisions; bitwise-equal to :func:`tridiag`."""
    nz = b.shape[0]
    if nz == 1:
        return b * bet
    x0 = b[0] * bet[0]

    def fwd(xprev, inp):
        betk, ddm, bk = inp
        xk = (bk - ddm * xprev) * betk
        return xk, xk

    _, xs = jax.lax.scan(fwd, x0, (bet[1:], ud, b[1:]))
    x = jnp.concatenate([x0[None], xs], axis=0)

    def bwd(xnext, inp):
        gamk1, xk = inp
        xk = xk - gamk1 * xnext
        return xk, xk

    _, head = jax.lax.scan(bwd, x[-1], (gam, x[:-1]), reverse=True)
    return jnp.concatenate([head, x[-1:]], axis=0)


def tridiag(d: jnp.ndarray, dd: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Thomas solve of symmetric tridiagonal systems, batched over (ny, nx).

    Exact transcription of ``tridiag`` (mg_relax.f90:308-334): ``d`` (nz,...)
    diagonal, ``dd`` (nz-1,...) off-diagonal (coupling k<->k+1), ``b`` RHS.
    Sequential in z by nature; a scan step is an elementwise (ny, nx) op so
    every step is a full-width (ny, nx) vector op.
    """
    nz = d.shape[0]
    if nz == 1:
        return b / d
    bet0 = 1.0 / d[0]
    x0 = b[0] * bet0

    def fwd(carry, inp):
        bet, xprev = carry
        dk, ddm, bk = inp
        gam = ddm * bet
        bet = 1.0 / (dk - ddm * gam)
        xk = (bk - ddm * xprev) * bet
        return (bet, xk), (gam, xk)

    (_, _), (gams, xs) = jax.lax.scan(fwd, (bet0, x0), (d[1:], dd, b[1:]))
    x = jnp.concatenate([x0[None], xs], axis=0)

    def bwd(xnext, inp):
        gamk1, xk = inp
        xk = xk - gamk1 * xnext
        return xk, xk

    _, head = jax.lax.scan(bwd, x[-1], (gams, x[:-1]), reverse=True)
    return jnp.concatenate([head, x[-1:]], axis=0)


def _column_solve(pe: jnp.ndarray, b: jnp.ndarray, cA: jnp.ndarray,
                  real_matrix: bool, method: str = "thomas") -> jnp.ndarray:
    """Exact solve of every z-column given current neighbour columns
    (relax_3D_8_heart for all (i, j) at once)."""
    rhs = b - offdiag_columns(pe, cA, real_matrix)
    d = band(cA, 1)
    ud = cA[1][1:, 1:-1, 1:-1]      # ud(k) = cA2(k+1) (mg_relax.f90:279,290)
    solver = tridiag_pcr if method == "pcr" else tridiag
    return solver(d, ud, rhs)


def _parity_mask(ny: int, nx: int, c: int, j0: int, i0: int,
                 dtype) -> jnp.ndarray:
    """Columns of color ``c``: global (i + j + c) even selects color 0 first
    (reference sweep order ``j = 1+mod(i+rb,2)``, mg_relax.f90:172-174).
    ``j0, i0`` are global offsets of this shard's interior origin."""
    jj = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 0) + j0
    ii = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 1) + i0
    return ((jj + ii + c) % 2 == 0).astype(dtype)


def relax(p: jnp.ndarray, b: jnp.ndarray, cA: jnp.ndarray,
          nsweeps: int, kind: str, real_matrix: bool,
          extend_fn: ExtendFn, j0: int = 0, i0: int = 0,
          tridiag_method: str = "thomas") -> jnp.ndarray:
    """``nsweeps`` smoothing sweeps (``relax`` dispatch, mg_relax.f90:16-47).

    ``extend_fn`` supplies halos (physical BCs and/or neighbour shards) and
    is invoked once per color — the reference's halo-per-color protocol.

    The sweep/color iteration is a ``lax.fori_loop`` whose body is one
    color update (the mask is selected by loop index): the coarsest level
    runs ns_coarsest=40 sweeps and unrolling 80 color updates into the
    traced program would blow up compile time.
    """
    ny, nx = p.shape[-2:]
    dt = p.dtype

    def color_update(p, mask):
        pe = extend_fn(p)
        sol = _column_solve(pe, b, cA, real_matrix, tridiag_method)
        return p + mask * (sol - p)

    if kind == "RB":
        masks = jnp.stack([_parity_mask(ny, nx, c, j0, i0, dt)
                           for c in (0, 1)])
    elif kind == "FC":
        # four colors in reference order (mg_relax.f90:214-228):
        # (i even, j even), (i even, j odd), (i odd, j even), (i odd, j odd)
        jj = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 0) + j0
        ii = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 1) + i0
        masks = jnp.stack([(((ii % 2) == t) & ((jj % 2) == s)).astype(dt)
                           for t, s in ((0, 0), (0, 1), (1, 0), (1, 1))])
    elif kind == "GS":
        masks = jnp.ones((1, ny, nx), dtype=dt)
    else:
        raise ValueError(f"unknown relax kind {kind!r}")

    ncolor = masks.shape[0]
    nsteps = nsweeps * ncolor

    def body(i, p):
        return color_update(p, masks[i % ncolor])

    if nsteps <= 2:
        for i in range(nsteps):
            p = body(i, p)
        return p
    return jax.lax.fori_loop(0, nsteps, body, p)


def relax_gs_exact(p: jnp.ndarray, b: jnp.ndarray, cA: jnp.ndarray,
                   nsweeps: int, real_matrix: bool,
                   extend_fn: ExtendFn) -> jnp.ndarray:
    """ORDER-EXACT sequential Gauss-Seidel (``relax_3D_8_GS``,
    mg_relax.f90:116-148): columns updated one at a time in the
    reference's i-outer / j-inner order, each reading the in-place
    updated values of every previously-visited column; halos refreshed
    once per sweep (:141 — so halo reads see pre-sweep values).

    This is a PARITY MODE, not a fast path: the dependency chain is fully
    sequential — column (i, j) reads (i, j-1) and (i-1, j+1), so even
    anti-diagonal wavefronts are serialized — and the lax.scan below
    embraces that (nx*ny steps of one nz-column each).  Use it on CPU/f64
    to reproduce reference GS histories; the default 'GS' path remains
    the simultaneous column-Jacobi sweep (documented deviation, fast on
    an accelerator).  Gather term order matches relax_3D_8_heart (:263-300) via the
    shared _BASE_TERMS/_REAL_TERMS tables, so iterates are bitwise the
    reference recurrence."""
    from .relax_compact import _BASE_TERMS, _REAL_TERMS
    nz, ny, nx = p.shape
    dt = p.dtype
    k0 = (jnp.arange(nz) == 0).astype(dt) if real_matrix else None

    def kshift1(v, dk):
        if dk == 0:
            return v
        z = jnp.zeros_like(v[:1])
        if dk == 1:
            return jnp.concatenate([v[1:], z], axis=0)
        return jnp.concatenate([z, v[:-1]], axis=0)

    def column(pe, idx):
        i = idx // ny               # i outer, j inner (mg_relax.f90:133-134)
        j = idx % ny
        je, ie = j + 1, i + 1       # extended coords
        nb = jax.lax.dynamic_slice(pe, (0, je - 1, ie - 1), (nz, 3, 3))
        cb = jax.lax.dynamic_slice(cA, (0, 0, je - 1, ie - 1),
                                   (8, nz, 3, 3))
        bcol = jax.lax.dynamic_slice(b, (0, j, i), (nz, 1, 1))[:, 0, 0]

        def term(n, boff, poff):
            bk, bj, bi = boff
            pk, pj, pi = poff
            return kshift1(cb[n - 1, :, 1 + bj, 1 + bi], bk) \
                * kshift1(nb[:, 1 + pj, 1 + pi], pk)

        s = None
        for n, boff, poff in _BASE_TERMS:
            t = term(n, boff, poff)
            s = t if s is None else s + t
        if real_matrix:
            x = None
            for n, boff, poff in _REAL_TERMS:
                t = term(n, boff, poff)
                x = t if x is None else x + t
            s = s + k0 * x
        sol = tridiag(cb[0, :, 1, 1], cb[1, 1:, 1, 1], bcol - s)
        pe = jax.lax.dynamic_update_slice(pe, sol[:, None, None],
                                          (0, je, ie))
        return pe, None

    for _ in range(nsweeps):
        pe = extend_fn(p)
        pe, _ = jax.lax.scan(column, pe, jnp.arange(nx * ny))
        p = pe[:, 1:-1, 1:-1]
    return p


# NOTE: no 2-D (nz==1) relaxation exists here by design.  The reference's
# relax_2D_5 (mg_relax.f90:50-113) is dead code: define_matrix has no 2-D
# assembly branch to feed it (mg_define_matrix.f90), and the level plan
# keeps nz >= 2 on the coarsest level (mg_grids.f90:485).  The solver
# raises explicitly if an nd==5 level is ever reached (solver.py).
