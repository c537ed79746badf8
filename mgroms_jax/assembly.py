"""Operator assembly: the 15-point sigma-coordinate pressure Laplacian.

JAX port of ``src/mg_define_matrix.f90``.  The reference assembles,
per multigrid level, 8 stored bands ``cA(1..8)`` of a symmetric 15-point
stencil via triple loops; here each band is one vectorized slice expression.
Assembly is one-time work, so plain jnp (no Pallas) is the right tool — XLA
fuses it into a handful of elementwise kernels.

Band semantics (comment block at mg_define_matrix.f90:219-227), with the
symmetric counterparts read at shifted positions by the smoother/residual:

  cA[0] -> p(k,  j,  i)   diagonal (negative row sum, :615-657)
  cA[1] -> p(k-1,j,  i)   vertical
  cA[2] -> p(k+1,j-1,i)
  cA[3] -> p(k,  j-1,i)
  cA[4] -> p(k-1,j-1,i)   (k=1: couples p(k,j+1,i-1) instead, :438-453)
  cA[5] -> p(k+1,j,  i-1)
  cA[6] -> p(k,  j,  i-1)
  cA[7] -> p(k-1,j,  i-1) (k=1: couples p(k,j-1,i-1) instead, :470-485)

Index/layout conventions (everywhere in this package):
  - 3-D arrays are (nz, ny, nx), z leading; 2-D metric fields are (ny, nx).
  - "e1" arrays are halo-1 extended: (ny+2, nx+2); extended index j in
    [0, ny+1] matches the reference's Fortran index j in [0, ny+1] directly.
  - "e2" arrays (zr, zw only) are halo-2 extended: (ny+4, nx+4).
  - Vertical index k below is 0-based python (Fortran k-1).

All bands are evaluated on their exact reference index ranges (zeros
elsewhere); halo-range band values computed here from consistently extended
metrics equal what the reference's MPI exchange would deliver, so no band
exchange is needed (the reference only exchanges cA when ``bmask``,
:611-613 — reproduced as a mirror of the physical ring).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from .bc import extend_h1, extend_h2, extend_rmask
from .config import SolverConfig
from .grids import setup_zr_zw_croco
from .levels import LevelSpec


class LevelOperator(NamedTuple):
    """Per-level assembled operator (all arrays halo-1 extended in j, i)."""

    cA: jnp.ndarray      # (8, nz, ny+2, nx+2) stencil bands
    umask: jnp.ndarray   # (ny+2, nx+2)
    vmask: jnp.ndarray   # (ny+2, nx+2)
    # dense inverse of the coarsest-level operator (nc, nc) for the
    # cfg.coarsest == 'direct' exact coarse solve; None elsewhere
    Ainv: jnp.ndarray | None = None


class FineMetrics(NamedTuple):
    """Level-0 metric fields shared by RHS / projection
    (grid_type members, mg_grids.f90:24-65)."""

    dx: jnp.ndarray      # (ny+2, nx+2)
    dy: jnp.ndarray
    zr: jnp.ndarray      # (nz,   ny+2, nx+2)
    zw: jnp.ndarray      # (nz+1, ny+2, nx+2)
    dzw: jnp.ndarray     # (nz+1, ny+2, nx+2) cell heights at w-points
    zx: jnp.ndarray      # (nz, ny+2, nx+2)  zxdy slopes (x-slope * dy)
    zy: jnp.ndarray      # (nz, ny+2, nx+2)  zydx slopes (y-slope * dx)
    cw: jnp.ndarray      # (nz+1, ny+2, nx+2) vertical conductances
    umask: jnp.ndarray   # (ny+2, nx+2)
    vmask: jnp.ndarray
    rmask: jnp.ndarray


def masks_from_rmask(rmaske: jnp.ndarray, bmask: bool
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """u/v-point masks from the rho-mask (mg_define_matrix.f90:256-275).

    umask(j,i) = rmask(j,i-1)*rmask(j,i) on i in [1, nx+1] (zero at i=0);
    vmask analogous in j.  Without ``bmask`` both are all-ones.
    """
    if not bmask:
        ones = jnp.ones_like(rmaske)
        return ones, ones
    umask = jnp.zeros_like(rmaske)
    vmask = jnp.zeros_like(rmaske)
    umask = umask.at[:, 1:].set(rmaske[:, :-1] * rmaske[:, 1:])
    vmask = vmask.at[1:, :].set(rmaske[:-1, :] * rmaske[1:, :])
    return umask, vmask


def slope_terms(dx: jnp.ndarray, dy: jnp.ndarray,
                zre: jnp.ndarray, zwe: jnp.ndarray
                ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """dzw, zx (zxdy), zy (zydx), cw on the halo-1 grid.

    Reference: dzw at mg_define_matrix.f90:283-293, slopes :295-306,
    cw conductances :309-336 (cw = Arz/dz * (1 + x-slope^2 + y-slope^2) with
    slopes of zw at the matching w-level).
    """
    zr1 = zre[:, 1:-1, 1:-1]
    zw1 = zwe[:, 1:-1, 1:-1]
    # cell heights at w-points: dzw[0] = zr(1)-zw(1); dzw[k] = zr diff;
    # dzw[nz] = zw(nz+1)-zr(nz)
    dzw = jnp.concatenate([zr1[0:1] - zw1[0:1],
                           zr1[1:] - zr1[:-1],
                           zw1[-1:] - zr1[-1:]], axis=0)
    # slopes at rho-points: zx = 0.5*(zr(i+1)-zr(i-1))/dx*dy (and x<->y)
    zx = 0.5 * (zre[:, 1:-1, 2:] - zre[:, 1:-1, :-2]) / dx * dy
    zy = 0.5 * (zre[:, 2:, 1:-1] - zre[:, :-2, 1:-1]) / dy * dx
    # vertical conductances with slope-squared metric terms
    sl2 = ((0.5 * (zwe[:, 1:-1, 2:] - zwe[:, 1:-1, :-2]) / dx) ** 2
           + (0.5 * (zwe[:, 2:, 1:-1] - zwe[:, :-2, 1:-1]) / dy) ** 2)
    cw = (dx * dy) / dzw * (1.0 + sl2)
    return dzw, zx, zy, cw


def _mirror_ring(a: jnp.ndarray) -> jnp.ndarray:
    """Overwrite the outermost extended ring with the adjacent values —
    the physical-boundary part of the 4-D cA exchange the reference runs
    when ``bmask`` (mg_define_matrix.f90:611-613 -> fill_halo_4D mirror)."""
    a = a.at[..., 0, :].set(a[..., 1, :])
    a = a.at[..., -1, :].set(a[..., -2, :])
    a = a.at[..., :, 0].set(a[..., :, 1])
    a = a.at[..., :, -1].set(a[..., :, -2])
    return a


def assemble_bands(dx: jnp.ndarray, dy: jnp.ndarray,
                   zre: jnp.ndarray, zwe: jnp.ndarray,
                   rmaske: jnp.ndarray, bmask: bool) -> LevelOperator:
    """Assemble all 8 bands for one level (``define_matrix``,
    mg_define_matrix.f90:211-680).

    Args:
      dx, dy: halo-1 extended horizontal spacings, (ny+2, nx+2).
      zre, zwe: halo-2 extended vertical grids, (nz[, +1], ny+4, nx+4).
      rmaske: halo-1 extended rho-mask.
    """
    nz = zre.shape[0]
    J, I = dx.shape
    ny, nx = J - 2, I - 2
    dtype = dx.dtype

    umask, vmask = masks_from_rmask(rmaske, bmask)
    _, zx, zy, cw = slope_terms(dx, dy, zre, zwe)
    zw1 = zwe[:, 1:-1, 1:-1]
    cwsum = cw[:-1] + cw[1:]              # cw(k)+cw(k+1) at rho-levels
    if bmask:
        # the swapped-metric x-slope of the reference's k=1 bmask cross
        # terms (x-difference / dy * dx — mg_define_matrix.f90:381,428;
        # its comments say zxdy but the code swaps the metrics)
        zxswap = 0.5 * (zre[:, 1:-1, 2:] - zre[:, 1:-1, :-2]) / dy * dx

    def rg(arr, dj, di, j0, j1, i0, i1):
        """arr[..., j+dj, i+di] for extended j in [j0, j1], i in [i0, i1]."""
        return arr[..., j0 + dj: j1 + 1 + dj, i0 + di: i1 + 1 + di]

    z8 = jnp.zeros((nz, J, I), dtype=dtype)

    # ---- cA3: couples (k+1, j-1, i); k in [1, nz-1] F / [0, nz-2] py;
    # j in [1, ny+1], i in [1, nx] (mg_define_matrix.f90:357-359, 519-522)
    j0, j1, i0, i1 = 1, ny + 1, 1, nx

    def s3(arr, dj=0, di=0):
        return rg(arr, dj, di, j0, j1, i0, i1)

    cA3 = z8.at[0:nz - 1, j0:j1 + 1, i0:i1 + 1].set(
        0.25 * (s3(zy)[1:] + s3(zy, dj=-1)[:-1]) * s3(vmask))

    # ---- cA4: couples (k, j-1, i); all k; j in [1, ny+1], i in [1, nx]
    # (:361-392 bottom, :524-527 interior, :576-582 top)
    ary_over_dyv = (0.25 * (s3(zw1)[1:] - s3(zw1)[:-1]
                            + s3(zw1, dj=-1)[1:] - s3(zw1, dj=-1)[:-1])
                    * (s3(dx) + s3(dx, dj=-1))
                    / (0.5 * (s3(dy) + s3(dy, dj=-1))))
    zy_j = s3(zy)[0]
    zy_jm = s3(zy, dj=-1)[0]
    cws_j = s3(cwsum)[0]
    cws_jm = s3(cwsum, dj=-1)[0]
    bot4 = (ary_over_dyv[0]
            - (zy_j ** 2 / cws_j + zy_jm ** 2 / cws_jm)
            - 0.25 * (zy_jm - zy_j))
    if bmask:
        # Code-faithful to mg_define_matrix.f90:371-392: the grouping is
        # -(T1 - T2) (net +T2), and T2's x-slope factor divides by dy and
        # multiplies dx — the reference's own comment labels it
        # zxdy(k,j,i) but the code swaps the metrics (repeated verbatim
        # in the cA7 block :420-433); parity reproduces the code, not
        # the comment (caught by tests/test_assembly_pin.py).
        bot4 = (bot4
                - 0.5 * s3(zx, dj=-1)[0] * zy_jm / cws_jm
                * (s3(umask, dj=-1, di=1) - s3(umask, dj=-1))
                + 0.5 * s3(zxswap)[0] * zy_j / cws_j
                * (s3(umask, di=1) - s3(umask))) * s3(vmask)
    zyt_j = s3(zy)[-1]
    zyt_jm = s3(zy, dj=-1)[-1]
    top4 = (ary_over_dyv[-1] + 0.25 * (-zyt_jm + zyt_j)) * s3(vmask)
    mid4 = ary_over_dyv[1:-1] * s3(vmask)
    cA4 = z8.at[:, j0:j1 + 1, i0:i1 + 1].set(
        jnp.concatenate([bot4[None], mid4, top4[None]], axis=0))

    # ---- cA5: k>=2 couples (k-1, j-1, i) on j in [1, ny+1], i in [1, nx]
    # (:529-532, :584-587); k=1 exceptionally couples (k, j+1, i-1) on
    # j in [0, ny], i in [1, nx+1] (:438-453)
    cA5 = z8.at[1:, j0:j1 + 1, i0:i1 + 1].set(
        -0.25 * (s3(zy)[:-1] + s3(zy, dj=-1)[1:]) * s3(vmask))
    jb0, jb1, ib0, ib1 = 0, ny, 1, nx + 1

    def s5(arr, dj=0, di=0):
        return rg(arr, dj, di, jb0, jb1, ib0, ib1)

    cA5 = cA5.at[0, jb0:jb1 + 1, ib0:ib1 + 1].set(
        0.5 * s5(zx, dj=1)[0] * s5(zy, dj=1)[0] / s5(cwsum, dj=1)[0]
        * s5(umask, dj=1) * s5(vmask, dj=1)
        + 0.5 * s5(zx, di=-1)[0] * s5(zy, di=-1)[0] / s5(cwsum, di=-1)[0]
        * s5(umask) * s5(vmask, dj=1, di=-1))

    # ---- cA6: couples (k+1, j, i-1); k in [0, nz-2] py; j in [1, ny],
    # i in [1, nx+1] (:397-400, :542-545)
    j0, j1, i0, i1 = 1, ny, 1, nx + 1

    def s6(arr, dj=0, di=0):
        return rg(arr, dj, di, j0, j1, i0, i1)

    cA6 = z8.at[0:nz - 1, j0:j1 + 1, i0:i1 + 1].set(
        0.25 * (s6(zx)[1:] + s6(zx, di=-1)[:-1]) * s6(umask))

    # ---- cA7: couples (k, j, i-1); all k; j in [1, ny], i in [1, nx+1]
    # (:402-433 bottom, :547-550 interior, :595-601 top)
    arx_over_dxu = (0.25 * (s6(zw1)[1:] - s6(zw1)[:-1]
                            + s6(zw1, di=-1)[1:] - s6(zw1, di=-1)[:-1])
                    * (s6(dy) + s6(dy, di=-1))
                    / (0.5 * (s6(dx) + s6(dx, di=-1))))
    zx_i = s6(zx)[0]
    zx_im = s6(zx, di=-1)[0]
    cws_i = s6(cwsum)[0]
    cws_im = s6(cwsum, di=-1)[0]
    bot7 = (arx_over_dxu[0]
            - (zx_i ** 2 / cws_i + zx_im ** 2 / cws_im)
            - 0.25 * (zx_im - zx_i))
    if bmask:
        # -(T1 - T2) with the same swapped-metric T2 x-slope as cA4's
        # bmask block (mg_define_matrix.f90:420-433) — see the note there
        bot7 = (bot7
                - 0.5 * zx_im * s6(zy, di=-1)[0] / cws_im
                * (s6(vmask, dj=1, di=-1) - s6(vmask, di=-1))
                + 0.5 * s6(zxswap)[0] * s6(zy)[0] / cws_i
                * (s6(vmask, dj=1) - s6(vmask))) * s6(umask)
    top7 = (arx_over_dxu[-1]
            + 0.25 * (-s6(zx, di=-1)[-1] + s6(zx)[-1])) * s6(umask)
    mid7 = arx_over_dxu[1:-1] * s6(umask)
    cA7 = z8.at[:, j0:j1 + 1, i0:i1 + 1].set(
        jnp.concatenate([bot7[None], mid7, top7[None]], axis=0))

    # ---- cA8: k>=2 couples (k-1, j, i-1) on j in [1, ny], i in [1, nx+1]
    # (:552-555, :603-606); k=1 exceptionally couples (k, j-1, i-1) on
    # j in [1, ny+1], i in [1, nx+1] (:470-485)
    cA8 = z8.at[1:, j0:j1 + 1, i0:i1 + 1].set(
        -0.25 * (s6(zx)[:-1] + s6(zx, di=-1)[1:]) * s6(umask))
    jb0, jb1, ib0, ib1 = 1, ny + 1, 1, nx + 1

    def s8(arr, dj=0, di=0):
        return rg(arr, dj, di, jb0, jb1, ib0, ib1)

    cA8 = cA8.at[0, jb0:jb1 + 1, ib0:ib1 + 1].set(
        -0.5 * s8(zx, dj=-1)[0] * s8(zy, dj=-1)[0] / s8(cwsum, dj=-1)[0]
        * s8(umask, dj=-1) * s8(vmask)
        - 0.5 * s8(zx, di=-1)[0] * s8(zy, di=-1)[0] / s8(cwsum, di=-1)[0]
        * s8(umask) * s8(vmask, di=-1))

    # ---- cA2: couples (k-1, j, i); k in [2, nz] F / [1, nz-1] py, interior
    # (j, i) only (:492-513 with bmask cross terms, :567-571 top)
    j0, j1, i0, i1 = 1, ny, 1, nx

    def si(arr, dj=0, di=0):
        return rg(arr, dj, di, j0, j1, i0, i1)

    cA2_val = si(cw)[1:nz]
    if bmask and nz > 2:
        du = si(umask, di=1) - si(umask)
        dv = si(vmask, dj=1) - si(vmask)
        cross = (-0.25 * (si(zx)[0:nz - 2] - si(zx)[1:nz - 1]) * du
                 - 0.25 * (si(zy)[0:nz - 2] - si(zy)[1:nz - 1]) * dv)
        cA2_val = cA2_val.at[0:nz - 2].add(cross)
    cA2 = z8.at[1:, j0:j1 + 1, i0:i1 + 1].set(cA2_val)

    if bmask:
        cA2, cA3, cA4, cA5, cA6, cA7, cA8 = (
            _mirror_ring(c) for c in (cA2, cA3, cA4, cA5, cA6, cA7, cA8))

    # ---- cA1: diagonal = negative row sum, interior only (:615-657)
    bot1 = (-si(cA2)[1]
            - si(cA4)[0] - si(cA4, dj=1)[0]
            - si(cA7)[0] - si(cA7, di=1)[0]
            - si(cA6)[0] - si(cA8, di=1)[1]
            - si(cA3)[0] - si(cA5, dj=1)[1]
            - si(cA5)[0] - si(cA5, dj=-1, di=1)[0]
            - si(cA8)[0] - si(cA8, dj=1, di=1)[0])
    if nz > 2:
        mid1 = (-si(cA2)[1:nz - 1] - si(cA2)[2:nz]
                - si(cA4)[1:nz - 1] - si(cA4, dj=1)[1:nz - 1]
                - si(cA7)[1:nz - 1] - si(cA7, di=1)[1:nz - 1]
                - si(cA6)[1:nz - 1] - si(cA6, di=1)[0:nz - 2]
                - si(cA8)[1:nz - 1] - si(cA8, di=1)[2:nz]
                - si(cA3)[1:nz - 1] - si(cA3, dj=1)[0:nz - 2]
                - si(cA5)[1:nz - 1] - si(cA5, dj=1)[2:nz])
    else:
        mid1 = z8[0:0, j0:j1 + 1, i0:i1 + 1]
    # top diagonal carries the free-surface terms (:641-654)
    top1 = (-si(cA2)[nz - 1]
            - si(cw)[nz]
            + 0.5 * si(zx, di=1)[nz - 1] - 0.5 * si(zx, di=-1)[nz - 1]
            + 0.5 * si(zy, dj=1)[nz - 1] - 0.5 * si(zy, dj=-1)[nz - 1]
            - si(cA4)[nz - 1] - si(cA4, dj=1)[nz - 1]
            - si(cA7)[nz - 1] - si(cA7, di=1)[nz - 1]
            - si(cA6, di=1)[nz - 2]
            - si(cA8)[nz - 1]
            - si(cA3, dj=1)[nz - 2]
            - si(cA5)[nz - 1])
    cA1 = z8.at[:, j0:j1 + 1, i0:i1 + 1].set(
        jnp.concatenate([bot1[None], mid1, top1[None]], axis=0))
    # halo diagonal entries are never read by the solver but appear as
    # divisors in the vectorized tridiagonal solve — keep them 1, not 0
    ring = jnp.zeros((J, I), dtype=dtype).at[1:-1, 1:-1].set(1.0)
    cA1 = jnp.where(ring == 0.0, jnp.ones_like(cA1), cA1)

    cA = jnp.stack([cA1, cA2, cA3, cA4, cA5, cA6, cA7, cA8], axis=0)
    return LevelOperator(cA=cA, umask=umask, vmask=vmask)


def dense_inverse(op: LevelOperator, cfg: SolverConfig) -> jnp.ndarray:
    """Dense inverse of a (small) level operator for the exact coarse solve.

    Built by applying the stencil to unit vectors (the same dense-operator
    construction the test suite uses against the direct solver).  Inversion
    happens in float64 for conditioning, cast back to the working dtype.
    """
    import jax

    from .ops.stencil import apply_op
    from .bc import extend_h1

    nz, J, I = op.cA.shape[1:]
    ny, nx = J - 2, I - 2
    n = nz * ny * nx
    eye = jnp.eye(n, dtype=op.cA.dtype).reshape(n, nz, ny, nx)
    cols = jax.vmap(
        lambda e: apply_op(extend_h1(e), op.cA, cfg.cmatrix == "real"))(eye)
    A = cols.reshape(n, n).T
    return jnp.linalg.inv(A).astype(op.cA.dtype)


def coarsen_metric(f: jnp.ndarray, weight: float) -> jnp.ndarray:
    """2x2 metric coarsening (mg_define_matrix.f90:116-138): ``weight`` is
    0.5 for spacings (dx, dy) and 0.25 for heights (zeta, h)."""
    return weight * (f[0::2, 0::2] + f[1::2, 0::2]
                     + f[0::2, 1::2] + f[1::2, 1::2])


def build_operators(levels: list[LevelSpec],
                    dx: jnp.ndarray, dy: jnp.ndarray,
                    zeta: jnp.ndarray, h: jnp.ndarray,
                    rmask: jnp.ndarray,
                    hc: float, theta_b: float, theta_s: float,
                    cfg: SolverConfig,
                    ) -> Tuple[list[LevelOperator], FineMetrics]:
    """Assemble every level from the model topography
    (``define_matrices_topo``, mg_define_matrix.f90:28-208).

    Re-discretization multigrid: each coarse level coarsens the *metrics*
    (dx, dy x 0.5-sum4; zeta, h x 0.25-sum4) and re-runs the s-coordinate
    and stencil assembly — not a Galerkin product.

    All inputs are interior-only (ny, nx) arrays; halo extension (the
    reference's fill_halo calls at :165-185) happens here functionally.
    """
    ops: list[LevelOperator] = []
    fine: FineMetrics | None = None
    dxl, dyl, zetal, hl = dx, dy, zeta, h
    for spec in levels:
        if spec.index > 0:
            if spec.aggressive_from_prev:
                raise NotImplementedError(
                    "aggressive z-coarsening of matrices is not available "
                    "(parity with mg_define_matrix.f90:108-112)")
            dxl = coarsen_metric(dxl, 0.5)
            dyl = coarsen_metric(dyl, 0.5)
            zetal = coarsen_metric(zetal, 0.25)
            hl = coarsen_metric(hl, 0.25)
            # coarse levels use an all-water mask with a bmask ring
            # (mg_define_matrix.f90:156-162)
            rmaskl = jnp.ones_like(hl)
        else:
            rmaskl = rmask
        dxe = extend_h1(dxl)
        dye = extend_h1(dyl)
        rmaske = extend_rmask(rmaskl, cfg.bmask)
        zr, zw = setup_zr_zw_croco(hc, theta_b, theta_s, zetal, hl, spec.nzg)
        zre = extend_h2(zr)
        zwe = extend_h2(zw)
        op = assemble_bands(dxe, dye, zre, zwe, rmaske, cfg.bmask)
        if cfg.coarsest == "direct" and spec.index == len(levels) - 1:
            op = op._replace(Ainv=dense_inverse(op, cfg))
        ops.append(op)
        if spec.index == 0:
            dzw, zx, zy, cw = slope_terms(dxe, dye, zre, zwe)
            fine = FineMetrics(dx=dxe, dy=dye,
                               zr=zre[:, 1:-1, 1:-1], zw=zwe[:, 1:-1, 1:-1],
                               dzw=dzw, zx=zx, zy=zy, cw=cw,
                               umask=op.umask, vmask=op.vmask, rmask=rmaske)
    assert fine is not None
    return ops, fine
