"""Right-hand side: divergence of the sigma-coordinate volume fluxes.

JAX port of ``compute_rhs`` (src/mg_compute_rhs.f90:14-379).  The
reference builds staggered fluxes uf/vf/wf with slope cross-terms in three
triple-loop sweeps (reusing one scratch array); here each flux is one
vectorized expression and the divergence is three shifted differences —
XLA fuses the whole thing.

Velocity layout (matches the reference interfaces, nhydro.f90:56-59, with
z leading):
  u: (nz,   ny+2, nx+1)  faces ifc=0..nx  <-> Fortran u(1:nx+1, 0:ny+1, nz)
  v: (nz,   ny+1, nx+2)  faces jfc=0..ny  <-> Fortran v(0:nx+1, 1:ny+1, nz)
  w: (nz+1, ny+2, nx+2)  faces kw=0..nz   <-> Fortran w(0:nx+1, 0:ny+1, 0:nz)
  (kw=0 is the bottom face, kw=nz the free surface)

The reference's ``fill_halo(uf, lbc_null='u')`` zeroes the wall-normal flux
at *physical* walls (mg_mpi_exchange.f90:972-1013); pass face masks
(``uface_mask``/``vface_mask``) that encode which faces are walls — the
model layer builds them from the shard's position.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from ..assembly import FineMetrics


def wall_face_masks(ny: int, nx: int, dtype,
                    west: bool = True, east: bool = True,
                    south: bool = True, north: bool = True):
    """Face masks zeroing wall-normal fluxes at physical walls
    (the ``lbc_null`` Dirichlet of mg_mpi_exchange.f90:972-1013)."""
    um = jnp.ones((ny, nx + 1), dtype=dtype)
    if west:
        um = um.at[:, 0].set(0.0)
    if east:
        um = um.at[:, -1].set(0.0)
    vm = jnp.ones((ny + 1, nx), dtype=dtype)
    if south:
        vm = vm.at[0, :].set(0.0)
    if north:
        vm = vm.at[-1, :].set(0.0)
    return um, vm


def compute_rhs(m: FineMetrics, u: jnp.ndarray, v: jnp.ndarray,
                w: jnp.ndarray, bmask: bool,
                uface_mask: Optional[jnp.ndarray] = None,
                vface_mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """b = div(fluxes) on the interior, (nz, ny, nx)."""
    nz = u.shape[0]
    J, I = m.dx.shape
    ny, nx = J - 2, I - 2
    dt = u.dtype
    cwsum = m.cw[:-1] + m.cw[1:]

    # vertical weighting of the w slope terms: bottom cell has no lower-face
    # part (mg_compute_rhs.f90:100-131), top cell doubles the surface part
    # (:152-168 "two *")
    wlo = jnp.ones((nz, 1, 1), dtype=dt).at[0].set(0.0)
    whi = jnp.ones((nz, 1, 1), dtype=dt).at[-1].set(2.0)
    k0 = jnp.zeros((nz, 1, 1), dtype=dt).at[0].set(1.0)

    # ---------------- UF: u-fluxes on (nz, ny, nx+1) ----------------
    def MU(arr, di=0):
        """metric at (j, i+di) for interior rows j and faces i=1..nx+1."""
        return arr[..., 1:ny + 1, 1 + di: nx + 2 + di]

    uu = u[:, 1:ny + 1, :]

    def wU_at(di):
        return w[:, 1:ny + 1, 1 + di:nx + 2 + di]

    arx = (0.25 * (MU(m.zw)[1:] - MU(m.zw)[:-1]
                   + MU(m.zw, -1)[1:] - MU(m.zw, -1)[:-1])
           * (MU(m.dy) + MU(m.dy, -1)))
    wterm_u = 0.25 * (
        MU(m.zx) * (wlo * MU(m.dzw)[:-1] * wU_at(0)[:-1]
                    + whi * MU(m.dzw)[1:] * wU_at(0)[1:]) * MU(m.rmask)
        + MU(m.zx, -1) * (wlo * MU(m.dzw, -1)[:-1] * wU_at(-1)[:-1]
                          + whi * MU(m.dzw, -1)[1:] * wU_at(-1)[1:])
        * MU(m.rmask, -1))
    # bottom-cell metric terms (:113-128): slope^2 drag on u plus u-v cross
    dxu = 0.5 * (MU(m.dx) + MU(m.dx, -1))

    def dyv_at(dj, di):
        """dyv(j+dj, i+di) = 0.5*(dy(j+dj,i+di)+dy(j+dj-1,i+di)) on uf pts."""
        return 0.5 * (m.dy[1 + dj:ny + 1 + dj, 1 + di:nx + 2 + di]
                      + m.dy[dj:ny + dj, 1 + di:nx + 2 + di])

    def v_at(dj, di):
        """v(i+di, j+dj) at uf points (v-face row j+dj-1, col i+di)."""
        return v[:, dj:ny + dj, 1 + di:nx + 2 + di]

    def vmask_at(dj, di):
        return m.vmask[1 + dj:ny + 1 + dj, 1 + di:nx + 2 + di]

    slope2_u = (MU(m.zx)[0] ** 2 / MU(cwsum)[0]
                + MU(m.zx, -1)[0] ** 2 / MU(cwsum, -1)[0]) * dxu * uu[0]
    vbar = 0.5 * (dyv_at(0, 0) * v_at(0, 0)[0] * vmask_at(0, 0)
                  + dyv_at(1, 0) * v_at(1, 0)[0] * vmask_at(1, 0))
    vbar_im = 0.5 * (dyv_at(0, -1) * v_at(0, -1)[0] * vmask_at(0, -1)
                     + dyv_at(1, -1) * v_at(1, -1)[0] * vmask_at(1, -1))
    cross_u = (MU(m.zx)[0] * MU(m.zy)[0] / MU(cwsum)[0] * vbar
               + MU(m.zx, -1)[0] * MU(m.zy, -1)[0] / MU(cwsum, -1)[0]
               * vbar_im)
    uf = (arx * uu - wterm_u - k0 * (slope2_u + cross_u)[None]) \
        * MU(m.umask)
    if not bmask:
        if uface_mask is None:
            uface_mask, _ = wall_face_masks(ny, nx, dt)
        uf = uf * uface_mask

    # ---------------- VF: v-fluxes on (nz, ny+1, nx) ----------------
    def MV(arr, dj=0, di=0):
        """metric at (j+dj, i+di) for faces j=1..ny+1 and interior i."""
        return arr[..., 1 + dj: ny + 2 + dj, 1 + di: nx + 1 + di]

    vv = v[:, :, 1:nx + 1]
    wV = w[:, :, 1:nx + 1]
    ary = (0.25 * (MV(m.zw)[1:] - MV(m.zw)[:-1]
                   + MV(m.zw, -1)[1:] - MV(m.zw, -1)[:-1])
           * (MV(m.dx) + MV(m.dx, -1)))

    def wV_at(dj):
        return wV[:, 1 + dj:ny + 2 + dj, :]

    wterm_v = 0.25 * (
        MV(m.zy) * (wlo * MV(m.dzw)[:-1] * wV_at(0)[:-1]
                    + whi * MV(m.dzw)[1:] * wV_at(0)[1:]) * MV(m.rmask)
        + MV(m.zy, -1) * (wlo * MV(m.dzw, -1)[:-1] * wV_at(-1)[:-1]
                          + whi * MV(m.dzw, -1)[1:] * wV_at(-1)[1:])
        * MV(m.rmask, -1))
    dyv = 0.5 * (MV(m.dy) + MV(m.dy, -1))

    def u_at(dj, di):
        """u(i+di, j+dj) at vf points: rows j+dj, face cols i-1+di+1."""
        return u[:, 1 + dj:ny + 2 + dj, di:nx + di]

    def dxu_at(dj, di):
        return 0.5 * (m.dx[1 + dj:ny + 2 + dj, 1 + di:nx + 1 + di]
                      + m.dx[1 + dj:ny + 2 + dj, di:nx + di])

    def umask_at(dj, di):
        return m.umask[1 + dj:ny + 2 + dj, 1 + di:nx + 1 + di]

    slope2_v = (MV(m.zy)[0] ** 2 / MV(cwsum)[0]
                + MV(m.zy, -1)[0] ** 2 / MV(cwsum, -1)[0]) * dyv * vv[0]
    ubar = 0.5 * (dxu_at(0, 0) * u_at(0, 0)[0] * umask_at(0, 0)
                  + dxu_at(0, 1) * u_at(0, 1)[0] * umask_at(0, 1))
    ubar_jm = 0.5 * (dxu_at(-1, 0) * u_at(-1, 0)[0] * umask_at(-1, 0)
                     + dxu_at(-1, 1) * u_at(-1, 1)[0] * umask_at(-1, 1))
    cross_v = (MV(m.zy)[0] * MV(m.zx)[0] / MV(cwsum)[0] * ubar
               + MV(m.zy, -1)[0] * MV(m.zx, -1)[0] / MV(cwsum, -1)[0]
               * ubar_jm)
    vf = (ary * vv - wterm_v - k0 * (slope2_v + cross_v)[None]) \
        * MV(m.vmask)
    if not bmask:
        if vface_mask is None:
            _, vface_mask = wall_face_masks(ny, nx, dt)
        vf = vf * vface_mask

    # ---------------- WF: w-fluxes on (nz+1, ny, nx) ----------------
    def MI(arr, dj=0, di=0):
        """metric at interior (j+dj, i+di)."""
        return arr[..., 1 + dj: ny + 1 + dj, 1 + di: nx + 1 + di]

    # per-cell horizontal transports (shared by interior faces and surface)
    uterm = MI(m.zx) * (
        (MI(m.dx) + MI(m.dx, di=-1)) * u[:, 1:ny + 1, 0:nx] * MI(m.umask)
        + (MI(m.dx, di=1) + MI(m.dx)) * u[:, 1:ny + 1, 1:nx + 1]
        * MI(m.umask, di=1))
    vterm = MI(m.zy) * (
        (MI(m.dy) + MI(m.dy, dj=-1)) * v[:, 0:ny, 1:nx + 1] * MI(m.vmask)
        + (MI(m.dy, dj=1) + MI(m.dy)) * v[:, 1:ny + 1, 1:nx + 1]
        * MI(m.vmask, dj=1))
    wI = w[:, 1:ny + 1, 1:nx + 1]
    # interior faces kw=1..nz-1 (:308-338): couple cells kw and kw-1
    wf_int = (MI(m.cw)[1:nz] * MI(m.dzw)[1:nz] * wI[1:nz]
              - 0.125 * (uterm[1:nz] + uterm[0:nz - 1])
              - 0.125 * (vterm[1:nz] + vterm[0:nz - 1]))
    # surface face (:340-356)
    wf_top = (MI(m.cw)[nz] * MI(m.dzw)[nz] * wI[nz]
              - 0.25 * uterm[nz - 1] - 0.25 * vterm[nz - 1])
    wf = jnp.concatenate(
        [jnp.zeros((1, ny, nx), dtype=dt), wf_int, wf_top[None]], axis=0)

    # ---------------- divergence (:178-186, :279-287, :362-370) -----------
    b = (uf[:, :, 1:] - uf[:, :, :-1]
         + vf[:, 1:, :] - vf[:, :-1, :]
         + wf[1:] - wf[:-1])
    return b
