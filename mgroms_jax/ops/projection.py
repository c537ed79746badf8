"""Velocity projection: subtract the pressure gradient.

JAX port of ``correct_uvw`` (src/mg_correct_uvw.f90:15-115).
Velocity layout as in ops/rhs.py.  The halo rows/columns of u, v, w are
corrected too (the reference loops include them, :73-110), using the
halo-extended pressure — at physical boundaries the mirror halo makes the
wall-normal gradient vanish, which is exactly the Neumann BC.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..assembly import FineMetrics


def correct_uvw(m: FineMetrics, pe: jnp.ndarray,
                u: jnp.ndarray, v: jnp.ndarray, w: jnp.ndarray
                ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Make (u, v, w) divergence-free given the solved pressure.

    ``pe`` is the halo-1 extended pressure (nz, ny+2, nx+2).
    """
    nz = pe.shape[0]
    J, I = m.dx.shape
    ny, nx = J - 2, I - 2

    # u on all rows j=0..ny+1 and faces i=1..nx+1 (:73-83)
    dxu = 0.5 * (m.dx[:, 1:] + m.dx[:, :-1])           # (ny+2, nx+1)
    du = (pe[:, :, 1:] - pe[:, :, :-1]) / dxu * m.umask[:, 1:]
    u = u - du

    # v on faces j=1..ny+1 and all columns i=0..nx+1 (:85-95)
    dyv = 0.5 * (m.dy[1:, :] + m.dy[:-1, :])           # (ny+1, nx+2)
    dv = (pe[:, 1:, :] - pe[:, :-1, :]) / dyv * m.vmask[1:, :]
    v = v - dv

    # w on interior faces kw=1..nz-1 (:100-103) and the surface (:105-107);
    # the bottom face kw=0 is untouched
    dzw_int = m.zr[1:] - m.zr[:-1]                     # (nz-1, ny+2, nx+2)
    dw_int = (pe[1:] - pe[:-1]) / dzw_int
    dzw_top = m.zw[nz] - m.zr[nz - 1]
    dw_top = (-pe[nz - 1]) / dzw_top
    zero = jnp.zeros_like(w[:1])
    w = w - jnp.concatenate([zero, dw_int, dw_top[None]], axis=0)
    return u, v, w
