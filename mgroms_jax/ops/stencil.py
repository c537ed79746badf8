"""15-point stencil application and residual.

JAX port of ``compute_residual_3D_8`` (src/mg_relax.f90:421-515).
The reference fuses residual + local squared norm in one triple loop; here
the residual is a sum of shifted-slice multiplies that XLA fuses into a
single fused kernel, and the norm is a ``jnp.sum`` the compiler fuses in.

The symmetric 15-point stencil stores 8 bands; each off-diagonal band is
read twice — once at the point, once mirrored at the neighbour that stores
the symmetric entry (e.g. the j+1 coupling is ``cA4(k,j+1,i)``).  Vertical
structure (bottom k=1 / interior / top k=nz special cases in the reference)
is handled by zero-padding the k-shifts: bands are zero outside their
assembly ranges, so the three Fortran branches collapse into one expression.
The only exception is the bottom-level ``cmatrix='real'`` horizontal
diagonal couplings (mg_relax.f90:475-480), added with an explicit k=0 term.

All functions take the halo-extended pressure ``pe`` (nz, ny+2, nx+2) and
the extended band stack ``cA`` (8, nz, ny+2, nx+2); outputs are interior
(nz, ny, nx).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def shift(pe: jnp.ndarray, dk: int, dj: int, di: int) -> jnp.ndarray:
    """Interior-shaped slice of extended ``pe`` at offset (dk, dj, di).

    k-offsets that fall outside [0, nz) yield zeros (no vertical halo: the
    vertical BCs live in the stencil coefficients themselves).
    """
    J, I = pe.shape[-2:]
    h = pe[..., 1 + dj: J - 1 + dj, 1 + di: I - 1 + di]
    if dk == 0:
        return h
    z = jnp.zeros_like(h[:1])
    if dk == 1:
        return jnp.concatenate([h[1:], z], axis=0)
    return jnp.concatenate([z, h[:-1]], axis=0)


def band(cA: jnp.ndarray, n: int, dk: int = 0, dj: int = 0, di: int = 0
         ) -> jnp.ndarray:
    """Band ``n`` (1-based, reference numbering) at offset (dk, dj, di)."""
    return shift(cA[n - 1], dk, dj, di)


def offdiag_columns(pe: jnp.ndarray, cA: jnp.ndarray, real_matrix: bool
                    ) -> jnp.ndarray:
    """Sum of all couplings to *other* (i, j) columns at each point.

    This is the neighbour-gather shared by the residual and the line
    smoother's tridiagonal RHS (mg_relax.f90:263-300): every term with a
    horizontal offset, excluding the in-column diagonal/vertical terms.
    """
    s = (
        # j-direction (bands 3, 4, 5 + symmetric reads)
        band(cA, 3) * shift(pe, 1, -1, 0)
        + band(cA, 3, dk=-1, dj=1) * shift(pe, -1, 1, 0)
        + band(cA, 4) * shift(pe, 0, -1, 0)
        + band(cA, 4, dj=1) * shift(pe, 0, 1, 0)
        + band(cA, 5) * shift(pe, -1, -1, 0)
        + band(cA, 5, dk=1, dj=1) * shift(pe, 1, 1, 0)
        # i-direction (bands 6, 7, 8 + symmetric reads)
        + band(cA, 6) * shift(pe, 1, 0, -1)
        + band(cA, 6, dk=-1, di=1) * shift(pe, -1, 0, 1)
        + band(cA, 7) * shift(pe, 0, 0, -1)
        + band(cA, 7, di=1) * shift(pe, 0, 0, 1)
        + band(cA, 8) * shift(pe, -1, 0, -1)
        + band(cA, 8, dk=1, di=1) * shift(pe, 1, 0, 1)
    )
    if real_matrix:
        # bottom-level horizontal-diagonal couplings: cA5(k=1) couples
        # (j+1, i-1), cA8(k=1) couples (j-1, i-1) (+ symmetric reads);
        # mg_relax.f90:271-276 / :475-480.  They exist on the k=1 plane
        # ONLY, so evaluate them there and fold in with a leading-axis
        # concat instead of a full-depth masked pass (4 of 16 terms on
        # 1/nz of the depth; bitwise the old k0-masked form on plane 0,
        # and s + 0.0 elsewhere up to signed zeros).  A concat, not
        # .at[].set, so the sum stays one fused expression.
        x0 = (band(cA, 5)[:1] * shift(pe, 0, 1, -1)[:1]
              + band(cA, 5, dj=-1, di=1)[:1] * shift(pe, 0, -1, 1)[:1]
              + band(cA, 8)[:1] * shift(pe, 0, -1, -1)[:1]
              + band(cA, 8, dj=1, di=1)[:1] * shift(pe, 0, 1, 1)[:1])
        s = jnp.concatenate([s[:1] + x0, s[1:]], axis=0)
    return s


def residual(pe: jnp.ndarray, b: jnp.ndarray, cA: jnp.ndarray,
             real_matrix: bool) -> jnp.ndarray:
    """r = b - A p on the interior (compute_residual_3D_8,
    mg_relax.f90:421-515).  ``b`` is interior (nz, ny, nx)."""
    r = (b
         - band(cA, 1) * shift(pe, 0, 0, 0)
         - band(cA, 2) * shift(pe, -1, 0, 0)
         - band(cA, 2, dk=1) * shift(pe, 1, 0, 0)
         - offdiag_columns(pe, cA, real_matrix))
    return r


def residual_and_norm(pe: jnp.ndarray, b: jnp.ndarray, cA: jnp.ndarray,
                      real_matrix: bool) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused residual + local squared norm (reference fuses these in one
    loop, mg_relax.f90:459-513; the global reduction is the caller's)."""
    r = residual(pe, b, cA, real_matrix)
    return r, jnp.sum(r * r)


def apply_op(pe: jnp.ndarray, cA: jnp.ndarray, real_matrix: bool
             ) -> jnp.ndarray:
    """A p on the interior (for tests: operator symmetry, Galerkin ratio)."""
    zero = jnp.zeros(
        (pe.shape[0], pe.shape[1] - 2, pe.shape[2] - 2), dtype=pe.dtype)
    return -residual(pe, zero, cA, real_matrix)
