"""Vertical (terrain-following) grid generation: zr / zw.

JAX port of ``src/mg_zr_zw.f90``.  The reference loops pointwise over
(i, j, k); here the three flavours are vectorized elementwise expressions
over a (ny, nx) field of depths — pure jnp, jit-friendly, shape-polymorphic
(works on interior or halo-extended inputs since the op is pointwise in the
horizontal).

Layout: 3-D outputs are (nz[, +1], ny, nx) — z leading so that vertical
scans (the tridiagonal direction) run over axis 0.

  - ``zr``: depth of cell centres (rho-points), shape (nz, ny, nx)
  - ``zw``: depth of cell faces (w-points), shape (nz+1, ny, nx);
    zw[0] = bottom, zw[nz] = free surface.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def setup_zr_zw_seamount(h: jnp.ndarray, nz: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Uniform sigma grid (``setup_zr_zw_seamount``, mg_zr_zw.f90:14-43).

    zr(k) = (k - 1/2) h/nz - h,  zw(k) = (k-1) h/nz - h, zw(nz+1) = 0
    (Fortran 1-based k).
    """
    dtype = h.dtype
    kr = (jnp.arange(1, nz + 1, dtype=dtype) - 0.5).reshape(nz, 1, 1)
    kw = jnp.arange(0, nz + 1, dtype=dtype).reshape(nz + 1, 1, 1)
    zr = kr * h / nz - h
    zw = kw * h / nz - h
    return zr, zw


def _cs_curve(sc: jnp.ndarray, theta_s: float, theta_b: float) -> jnp.ndarray:
    """CROCO 'new_s_coord' stretching curve (mg_zr_zw.f90:110-136)."""
    if theta_s > 0.0:
        csf = (1.0 - jnp.cosh(theta_s * sc)) / (jnp.cosh(theta_s) - 1.0)
    else:
        csf = -sc ** 2
    if theta_b > 0.0:
        cs = (jnp.exp(theta_b * csf) - 1.0) / (1.0 - jnp.exp(-theta_b))
    else:
        cs = csf
    return cs


def setup_zr_zw_croco(hlim: float, theta_b: float, theta_s: float,
                      zeta: jnp.ndarray, h: jnp.ndarray, nz: int,
                      coord_type: str = "new_s_coord",
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """CROCO s-coordinates (``setup_zr_zw_croco``, mg_zr_zw.f90:46-215).

    'new_s_coord' (:98-170): with hc = ``hlim``,
      z0 = hc*sc + Cs(sc)*h,  z = z0*h/(h+hc) + zeta*(1 + z0/(h+hc)).
    'sigma' (:175-213): legacy sinh/tanh stretching; the reference leaves its
    local ``hc`` uninitialized (latent bug — branch never taken by the
    drivers); we use ``hlim`` for it.
    """
    dtype = h.dtype
    k = jnp.arange(1, nz + 1, dtype=dtype)
    cff = 1.0 / nz
    sc_r = (cff * (k - nz - 0.5)).reshape(nz, 1, 1)
    sc_w = (cff * (jnp.arange(0, nz + 1, dtype=dtype) - nz)).reshape(nz + 1, 1, 1)

    if coord_type == "new_s_coord":
        cs_r = _cs_curve(sc_r, theta_s, theta_b)
        cs_w = _cs_curve(sc_w, theta_s, theta_b)
        hinv = 1.0 / (h + hlim)
        z_r0 = hlim * sc_r + cs_r * h
        z_w0 = hlim * sc_w + cs_w * h
        zr = z_r0 * h * hinv + zeta * (1.0 + z_r0 * hinv)
        zw = z_w0 * h * hinv + zeta * (1.0 + z_w0 * hinv)
        return zr, zw

    if coord_type == "sigma":
        cff1 = 1.0 / jnp.sinh(theta_s)
        cff2 = 0.5 / jnp.tanh(0.5 * theta_s)
        hc = hlim

        def cs_of(sc):
            return ((1.0 - theta_b) * cff1 * jnp.sinh(theta_s * sc)
                    + theta_b * (cff2 * jnp.tanh(theta_s * (sc + 0.5)) - 0.5))

        hinv = 1.0 / (h + hc)
        z_r0 = hc * sc_r + cs_of(sc_r) * h
        z_w0 = hc * sc_w + cs_of(sc_w) * h
        zr = z_r0 * (h * hinv)
        zw = z_w0 * (h * hinv)
        zw = zw.at[-1].set(jnp.zeros_like(h))
        return zr, zw

    raise ValueError(f"unknown coord_type {coord_type!r}")
