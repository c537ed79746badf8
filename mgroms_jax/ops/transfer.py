"""Inter-grid transfers: restriction and prolongation.

JAX port of ``src/mg_intergrids.f90``.  All functions act on
interior-only arrays; halo handling (the reference's fill_halo calls at
:68 and :224) belongs to the caller via ``extend``.

Restriction is the plain sum of the 8 children (no 1/8: the volume scaling
is absorbed by the re-discretized coarse operator — fine2coarse_3D,
mg_intergrids.f90:139-162).  Prolongation is trilinear (bilinear in the
horizontal x linear in z, with a bilinear-only bottom row and a halved top
row for the Dirichlet free surface — coarse2fine_3D_linear :366-450) or
8-way nearest injection (:336-363).
"""

from __future__ import annotations

import jax.numpy as jnp

# Pair sums use strided slices; interleaves stack behind the axis and fold
# the pair into it (_interleave).


def restrict_3d(r: jnp.ndarray) -> jnp.ndarray:
    """Coarse = sum of the 8 fine children (mg_intergrids.f90:139-162).
    Also covers the 3D->2D case (fine nz==2 -> coarse nz==1, :124-134).
    Pairwise strided-slice sums."""
    rz = r[0::2] + r[1::2]
    ry = rz[:, 0::2] + rz[:, 1::2]
    return ry[:, :, 0::2] + ry[:, :, 1::2]


def restrict_2d(r: jnp.ndarray) -> jnp.ndarray:
    """2-D levels: coarse = sum of the 4 fine children
    (fine2coarse_2D, mg_intergrids.f90:104-122)."""
    assert r.shape[0] == 1
    ry = r[:, 0::2] + r[:, 1::2]
    return ry[:, :, 0::2] + ry[:, :, 1::2]


def restrict_aggressive(r: jnp.ndarray) -> jnp.ndarray:
    """8:1 vertical-only averaging (fine2coarse_aggressive,
    mg_intergrids.f90:75-101): mean of 8 vertically stacked cells."""
    nz, ny, nx = r.shape
    return 0.125 * r.reshape(nz // 8, 8, ny, nx).sum(axis=1)


def restrict(r: jnp.ndarray, aggressive: bool = False) -> jnp.ndarray:
    if aggressive:
        return restrict_aggressive(r)
    if r.shape[0] == 1:
        return restrict_2d(r)
    return restrict_3d(r)


def _interleave(a0: jnp.ndarray, a1: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Merge two arrays so that out[..., 2m] = a0[..., m], out[..., 2m+1] =
    a1[..., m] along ``axis``: stack behind ``axis``, then fold the pair
    into it (a pure data movement, exact in every dtype)."""
    ax = axis if axis >= 0 else a0.ndim + axis
    stacked = jnp.stack([a0, a1], axis=ax + 1)
    shape = list(a0.shape)
    shape[ax] = 2 * a0.shape[ax]
    return stacked.reshape(shape)


def _bilinear_combos(xce: jnp.ndarray):
    """The four horizontal bilinear combinations H[t][s] per coarse cell.

    Weights a=9/16, b=3/16, c=1/16 (mg_intergrids.f90:377-379): the fine
    child at horizontal parity (t, s) leans toward the coarse neighbour at
    (j-1 if t==0 else j+1, i-1 if s==0 else i+1).
    ``xce`` is the halo-1 extended coarse field.
    """
    a, b_, c = 9.0 / 16.0, 3.0 / 16.0, 1.0 / 16.0
    J, I = xce.shape[-2:]

    def S(dj, di):
        return xce[..., 1 + dj: J - 1 + dj, 1 + di: I - 1 + di]

    H = {}
    for t, dj in ((0, -1), (1, 1)):
        for s, di in ((0, -1), (1, 1)):
            H[t, s] = (a * S(0, 0) + b_ * S(dj, 0)
                       + b_ * S(0, di) + c * S(dj, di))
    return H


def prolong_3d_linear(xce: jnp.ndarray) -> jnp.ndarray:
    """Trilinear prolongation (coarse2fine_3D_linear,
    mg_intergrids.f90:366-450) from halo-extended coarse (nzc, nyc+2, nxc+2)
    to fine interior (2*nzc, 2*nyc, 2*nxc).

    Vertical factorization: every fine value is 3/4 * H[main] +
    1/4 * H[partner] (d,e,f,g = (3/4, 1/4) x (a,b,c)), except the bottom
    fine row (pure H, nearest in z, :394-405) and the top fine row
    (0.5 * H — Dirichlet surface, :434-446).
    """
    nzc = xce.shape[0]
    H = _bilinear_combos(xce)

    def vprofile(Hc: jnp.ndarray) -> jnp.ndarray:
        # even fine rows k=2kc: kc==0 -> H[0]; else 0.75*H[kc] + 0.25*H[kc-1]
        ev = jnp.concatenate(
            [Hc[0:1], 0.75 * Hc[1:] + 0.25 * Hc[:-1]], axis=0)
        # odd fine rows k=2kc+1: kc<nzc-1 -> 0.75*H[kc] + 0.25*H[kc+1];
        # top (kc==nzc-1) -> 0.5*H[-1]
        od = jnp.concatenate(
            [0.75 * Hc[:-1] + 0.25 * Hc[1:], 0.5 * Hc[-1:]], axis=0)
        return _interleave(ev, od, axis=0)

    V = {ts: vprofile(Hc) for ts, Hc in H.items()}
    # y first at half width, x last
    lo = _interleave(V[0, 0], V[1, 0], axis=-2)
    hi = _interleave(V[0, 1], V[1, 1], axis=-2)
    return _interleave(lo, hi, axis=-1)


def prolong_3d_nearest(xce: jnp.ndarray) -> jnp.ndarray:
    """8-way injection (coarse2fine_3D_nearest, mg_intergrids.f90:336-363)."""
    xc = xce[..., 1:-1, 1:-1]
    xz = _interleave(xc, xc, axis=0)
    xy = _interleave(xz, xz, axis=-2)
    return _interleave(xy, xy, axis=-1)


def prolong_2d_linear(xce: jnp.ndarray) -> jnp.ndarray:
    """Bilinear prolongation for nz==1 levels (coarse2fine_2D_linear,
    mg_intergrids.f90:295-333)."""
    H = _bilinear_combos(xce)
    lo = _interleave(H[0, 0], H[1, 0], axis=-2)
    hi = _interleave(H[0, 1], H[1, 1], axis=-2)
    return _interleave(lo, hi, axis=-1)


def prolong_2d_nearest(xce: jnp.ndarray) -> jnp.ndarray:
    """4-way injection (coarse2fine_2D_nearest, mg_intergrids.f90:250-292)."""
    xc = xce[..., 1:-1, 1:-1]
    xy = _interleave(xc, xc, axis=-2)
    return _interleave(xy, xy, axis=-1)


def prolong_3d_linear_quads(xce: jnp.ndarray):
    """Trilinear prolongation emitting the fine field in QUAD-PARITY layout:
    ``{(t, s): V[t, s]}`` — the fine child at horizontal parity (t, s) IS
    the (t, s) quad, so the whole y/x interleave stage of
    :func:`prolong_3d_linear` (the ~150 ms minor-axis scatter matmuls at
    CUC level 0, round-2 piece timings in CLAUDE.md) simply vanishes.  Values are
    bitwise those of the full-array form."""
    H = _bilinear_combos(xce)

    def vprofile(Hc: jnp.ndarray) -> jnp.ndarray:
        ev = jnp.concatenate(
            [Hc[0:1], 0.75 * Hc[1:] + 0.25 * Hc[:-1]], axis=0)
        od = jnp.concatenate(
            [0.75 * Hc[:-1] + 0.25 * Hc[1:], 0.5 * Hc[-1:]], axis=0)
        return _interleave(ev, od, axis=0)      # z is major: layout-free

    return {ts: vprofile(Hc) for ts, Hc in H.items()}


def prolong_3d_nearest_quads(xce: jnp.ndarray):
    """8-way injection in quad layout: every quad is the z-doubled coarse
    field (coarse2fine_3D_nearest, mg_intergrids.f90:336-363)."""
    xc = xce[..., 1:-1, 1:-1]
    xz = _interleave(xc, xc, axis=0)
    return {(t, s): xz for t in (0, 1) for s in (0, 1)}


def prolong(xce: jnp.ndarray, fine_nz: int, interp_type: str,
            aggressive: bool = False, as_quads: bool = False):
    """Dispatch (coarse2fine, mg_intergrids.f90:196-222).  ``fine_nz`` is the
    target level's nz (2-D fine levels use the 2-D kernels).  With
    ``as_quads`` the 3-D result is returned as the quad dict
    ``{(y-parity, x-parity): (fine_nz, nyc, nxc)}`` instead of interleaved."""
    if aggressive:
        # parity with coarse2fine_aggressive (mg_intergrids.f90:231-247):
        # the reference stops with an error here as well
        raise NotImplementedError("aggressive prolongation not available "
                                  "(parity with mg_intergrids.f90:243-244)")
    if fine_nz == 1:
        assert not as_quads, "2-D levels are never quad-persistent"
        if interp_type == "linear":
            return prolong_2d_linear(xce)
        return prolong_2d_nearest(xce)
    # 3-D kernels; nzc == 1 (fine nz == 2 over a 2-D coarse level) falls out
    # of the same code path, matching the reference dispatch at :202-218
    assert xce.shape[0] * 2 == fine_nz
    if as_quads:
        return (prolong_3d_linear_quads(xce) if interp_type == "linear"
                else prolong_3d_nearest_quads(xce))
    if interp_type == "linear":
        return prolong_3d_linear(xce)
    return prolong_3d_nearest(xce)
