"""Explicit halo exchange: ppermute neighbour shifts inside shard_map.

JAX equivalent of the reference's MPI halo protocol
(``src/mg_mpi_exchange.f90``): 8-direction nonblocking ISend/IRecv with
physical BCs folded into the fill where a neighbour is ``MPI_PROC_NULL``
(:104-324, Neumann mirror :112-201).  Here each direction is a
``jax.lax.ppermute`` edge-slice shift over the ('py','px') mesh axes —
point-to-point traffic (NCCL on GPUs), exactly one neighbour hop — and domain-edge
shards substitute the homogeneous-Neumann mirror (edge copy, the nh=1 rule
of bc.extend_h1).

Corners: the exchange is two-phase — extend in x first, then exchange the
x-extended rows in y — so corner halo cells arrive transitively through the
cardinal neighbours (the reference instead sends 4 extra diagonal messages;
the two-phase form has the same result and matches its corner fallback
semantics, mg_mpi_exchange.f90:326-349).

These functions must run inside ``jax.shard_map`` over a mesh with the
named axes present; arrays are the *local* shard blocks (nz, ny_l, nx_l).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _extend_axis(x: jnp.ndarray, axis_name, ax: int) -> jnp.ndarray:
    """Halo-1 extension of local array ``x`` along dimension ``ax``
    (sharded over mesh axis ``axis_name``): neighbour edge slices via
    ppermute, physical mirror (edge copy) at the domain boundary.
    ``axis_name=None`` (axis dropped by staged agglomeration — the local
    block spans the full domain there) applies the physical mirror only."""
    n = 1 if axis_name is None else lax.axis_size(axis_name)
    m = x.shape[ax]
    lo_edge = lax.slice_in_dim(x, 0, 1, axis=ax)
    hi_edge = lax.slice_in_dim(x, m - 1, m, axis=ax)
    if n == 1:
        lo_halo, hi_halo = lo_edge, hi_edge
    else:
        idx = lax.axis_index(axis_name)
        # from my lower neighbour: its high edge (fills my low halo)
        from_lo = lax.ppermute(hi_edge, axis_name,
                               [(i, i + 1) for i in range(n - 1)])
        # from my upper neighbour: its low edge (fills my high halo)
        from_hi = lax.ppermute(lo_edge, axis_name,
                               [(i + 1, i) for i in range(n - 1)])
        lo_halo = jnp.where(idx == 0, lo_edge, from_lo)
        hi_halo = jnp.where(idx == n - 1, hi_edge, from_hi)
    return jnp.concatenate([lo_halo, x, hi_halo], axis=ax)


def halo_extend(x: jnp.ndarray, py_axis: str = "py", px_axis: str = "px"
                ) -> jnp.ndarray:
    """Local (…, ny_l, nx_l) -> (…, ny_l+2, nx_l+2) with neighbour data at
    shard seams and Neumann-mirror physical BCs at domain edges.  x-phase
    first, then y on the x-extended rows (corners ride along)."""
    x = _extend_axis(x, px_axis, x.ndim - 1)
    return _extend_axis(x, py_axis, x.ndim - 2)


def _edge_pair(lo_own, hi_own, lo_mirror, hi_mirror, axis_name):
    """Seam halos for a quad pair along one mesh axis: receive the
    neighbour's edge slice, substitute the physical mirror at the domain
    boundary.  ``lo_own``/``hi_own`` are the slices this shard SENDS (its
    first/last active row of the relevant quad); ``lo_mirror``/``hi_mirror``
    the in-shard mirror values used at the domain edges.
    ``axis_name=None`` (dropped axis): physical mirror only."""
    n = 1 if axis_name is None else lax.axis_size(axis_name)
    if n == 1:
        return lo_mirror, hi_mirror
    idx = lax.axis_index(axis_name)
    from_lo = lax.ppermute(hi_own, axis_name,
                           [(i, i + 1) for i in range(n - 1)])
    from_hi = lax.ppermute(lo_own, axis_name,
                           [(i + 1, i) for i in range(n - 1)])
    lo = jnp.where(idx == 0, lo_mirror, from_lo)
    hi = jnp.where(idx == n - 1, hi_mirror, from_hi)
    return lo, hi


def extend_quads_shard(q, py_axis: str = "py", px_axis: str = "px"):
    """Distributed quad-parity halo extension (inside shard_map).

    The seam image of ops/relax_compact.extend_quads: full j = -1 is the
    south neighbour's j = ny_l-1 (its quad a=1 row H-1); full j = ny_l is
    the north neighbour's j = 0 (quad a=0 row 0); physical edges keep the
    Neumann mirror from sibling quads.  Requires even local tiles so local
    quad parity equals global parity.  Two-phase (j then i on the
    j-extended arrays) so corner cells arrive transitively.
    """
    rj = {}
    for b in (0, 1):
        q0, q1 = q[(0, b)], q[(1, b)]
        # halo below quad1 (j=-1) / above quad0 (j=ny_l)
        lo, hi = _edge_pair(lo_own=q0[:, :1], hi_own=q1[:, -1:],
                            lo_mirror=q0[:, :1], hi_mirror=q1[:, -1:],
                            axis_name=py_axis)
        rj[(0, b)] = jnp.concatenate([q0[:, :1], q0, hi], axis=1)
        rj[(1, b)] = jnp.concatenate([lo, q1, q1[:, -1:]], axis=1)
    e = {}
    for a in (0, 1):
        r0, r1 = rj[(a, 0)], rj[(a, 1)]
        lo, hi = _edge_pair(lo_own=r0[:, :, :1], hi_own=r1[:, :, -1:],
                            lo_mirror=r0[:, :, :1], hi_mirror=r1[:, :, -1:],
                            axis_name=px_axis)
        e[(a, 0)] = jnp.concatenate([r0[:, :, :1], r0, hi], axis=2)
        e[(a, 1)] = jnp.concatenate([lo, r1, r1[:, :, -1:]], axis=2)
    return e


def axis_offsets(ny_l: int, nx_l: int, py_axis="py", px_axis="px"):
    """Global interior origin (j0, i0) of this shard — feeds the global
    red-black parity (reference color rule mod(i+j), mg_relax.f90:172).
    A ``None`` axis (dropped by staged agglomeration) has origin 0."""
    j0 = lax.axis_index(py_axis) * ny_l if py_axis else 0
    i0 = lax.axis_index(px_axis) * nx_l if px_axis else 0
    return j0, i0


def psum2(x: jnp.ndarray, py_axis: str = "py", px_axis: str = "px"):
    """Global scalar reduction over the mesh (``global_sum``,
    mg_mpi_exchange.f90:1555-1571)."""
    return lax.psum(lax.psum(x, px_axis), py_axis)


def block_overlapped(a: jnp.ndarray, npy: int, npx: int,
                     extra_j: int, extra_i: int) -> jnp.ndarray:
    """Blocked per-shard layout of a global array whose last two dims carry
    ``extra_j``/``extra_i`` overlap rows/columns beyond npy*ny_l / npx*nx_l
    (halo rings, staggered shared faces).  Block (pj, pi) holds global rows
    [pj*ny_l, pj*ny_l + ny_l + extra_j) x the analogous columns — adjacent
    blocks duplicate the overlap, exactly the reference's per-rank staggered
    storage (u(1:nx+1,0:ny+1,:) etc, nhydro.f90:56-59)."""
    nyg = a.shape[-2] - extra_j
    nxg = a.shape[-1] - extra_i
    ny_l, nx_l = nyg // npy, nxg // npx
    rows = []
    for pj in range(npy):
        cols = []
        for pi in range(npx):
            cols.append(a[..., pj * ny_l: pj * ny_l + ny_l + extra_j,
                          pi * nx_l: pi * nx_l + nx_l + extra_i])
        rows.append(jnp.concatenate(cols, axis=-1))
    return jnp.concatenate(rows, axis=-2)


def unblock_overlapped(ab: jnp.ndarray, npy: int, npx: int,
                       extra_j: int, extra_i: int) -> jnp.ndarray:
    """Inverse of :func:`block_overlapped` (overlap values agree by
    construction; each global entry is taken from one owner block)."""
    bj = ab.shape[-2] // npy            # ny_l + extra_j
    bi = ab.shape[-1] // npx
    ny_l, nx_l = bj - extra_j, bi - extra_i
    rows = []
    for pj in range(npy):
        blk = ab[..., pj * bj: (pj + 1) * bj, :]
        if pj < npy - 1:
            blk = blk[..., :ny_l, :]
        cols = []
        for pi in range(npx):
            c = blk[..., pi * bi: (pi + 1) * bi]
            if pi < npx - 1:
                c = c[..., :nx_l]
            cols.append(c)
        rows.append(jnp.concatenate(cols, axis=-1))
    return jnp.concatenate(rows, axis=-2)


def shard_face_masks(ny_l: int, nx_l: int, dtype,
                     py_axis: str = "py", px_axis: str = "px"):
    """Per-shard velocity-flux face masks: zero the wall-normal flux only
    at PHYSICAL walls (the distributed image of ops/rhs.wall_face_masks —
    the reference's ``lbc_null`` Dirichlet, mg_mpi_exchange.f90:952-1013).
    Must run inside shard_map."""
    pi = lax.axis_index(px_axis)
    pj = lax.axis_index(py_axis)
    west = pi == 0
    east = pi == lax.axis_size(px_axis) - 1
    south = pj == 0
    north = pj == lax.axis_size(py_axis) - 1
    icol = jnp.arange(nx_l + 1)[None, :]
    um = jnp.where((icol == 0) & west, 0.0, 1.0) \
        * jnp.where((icol == nx_l) & east, 0.0, 1.0)
    um = jnp.broadcast_to(um, (ny_l, nx_l + 1)).astype(dtype)
    jrow = jnp.arange(ny_l + 1)[:, None]
    vm = jnp.where((jrow == 0) & south, 0.0, 1.0) \
        * jnp.where((jrow == ny_l) & north, 0.0, 1.0)
    vm = jnp.broadcast_to(vm, (ny_l + 1, nx_l)).astype(dtype)
    return um, vm


def block_extended(a_ext: jnp.ndarray, npy: int, npx: int) -> jnp.ndarray:
    """Per-shard-extended blocked layout of a halo-extended global field.

    Input ``a_ext`` is (…, nyg+2, nxg+2) (interior + physical mirror ring).
    Output is (…, npy*(ny_l+2), npx*(nx_l+2)) where block (pj, pi) holds
    that shard's interior tile *plus its own halo ring* — neighbour-region
    values at interior seams, the physical ring at domain edges.  Sharded
    P('py','px') on the last two dims, each device stores exactly its
    extended tile: this is the reference's per-rank ``cA(nd,nz,0:ny+1,
    0:nx+1)`` storage (mg_grids.f90:24-65) and removes the operator
    replication cost of the GSPMD backend.
    """
    nyg, nxg = a_ext.shape[-2] - 2, a_ext.shape[-1] - 2
    ny_l, nx_l = nyg // npy, nxg // npx
    rows = []
    for pj in range(npy):
        cols = []
        for pi in range(npx):
            cols.append(a_ext[..., pj * ny_l: pj * ny_l + ny_l + 2,
                              pi * nx_l: pi * nx_l + nx_l + 2])
        rows.append(jnp.concatenate(cols, axis=-1))
    return jnp.concatenate(rows, axis=-2)
