"""Physical boundary conditions as functional halo extension.

The reference folds all physical BCs into its MPI halo fill
(``src/mg_mpi_exchange.f90``): where a neighbour is ``MPI_PROC_NULL`` the
halo is filled in-place with a homogeneous-Neumann mirror (:112-201 for 2-D;
:947-1077 for 3-D), a 2nd-order linear extrapolation for the nh=2 metric
halos (:956-963, scheme documented at :916-940), or a Dirichlet zero for
wall-normal velocity fluxes (``lbc_null``, :952-1013).

Here per-level state is interior-only and BCs are a *pure function*:
``extend()`` returns a halo-extended copy.  XLA fuses the concatenations
into the consuming stencil, so this costs no extra HBM round-trip.  The
distributed version (mgroms_jax/parallel/exchange.py) uses the same edge
rules at physical domain edges and ``ppermute`` data at shard seams.

Index convention: arrays are [..., j, i] (layout (nz, ny, nx) for 3-D
fields); extension acts on the last two axes.
"""

from __future__ import annotations

import jax.numpy as jnp


def extend_h1(a: jnp.ndarray) -> jnp.ndarray:
    """Halo-1 extension with homogeneous-Neumann mirror BCs.

    Mirror with nh=1 is an edge copy (mg_mpi_exchange.f90:112-141 for 2-D and
    :954-1024 for 3-D: ``p(:,0,1:nx) = p(:,1,1:nx)`` etc.); the corner
    double-mirror (:1041-1077) coincides with edge-of-edge padding.
    """
    pad = [(0, 0)] * (a.ndim - 2) + [(1, 1), (1, 1)]
    return jnp.pad(a, pad, mode="edge")


def extend_h2(a: jnp.ndarray) -> jnp.ndarray:
    """Halo-2 extension for the vertical-grid metrics (zr, zw).

    Edge rule (mg_mpi_exchange.f90:956-963): first halo = edge copy, second
    halo = linear extrapolation ``2*a[edge] - a[edge+1]`` — chosen so the
    second difference across the boundary continues smoothly (scheme derived
    in the comment block at :916-940).

    Corner rule (:1041-1077): the 2x2 corner blocks use the pure double
    mirror ``halo(d_j, d_i) = a(d_j-1, d_i-1)`` (d = distance outside), NOT
    extrapolation-of-extrapolation, so we patch them explicitly.
    """
    # j-direction edges (south/north), interior columns
    s1 = a[..., 0:1, :]
    s2 = 2.0 * a[..., 0:1, :] - a[..., 1:2, :]
    n1 = a[..., -1:, :]
    n2 = 2.0 * a[..., -1:, :] - a[..., -2:-1, :]
    aj = jnp.concatenate([s2, s1, a, n1, n2], axis=-2)
    # i-direction edges (west/east), all rows — corners overwritten below
    w1 = aj[..., :, 0:1]
    w2 = 2.0 * aj[..., :, 0:1] - aj[..., :, 1:2]
    e1 = aj[..., :, -1:]
    e2 = 2.0 * aj[..., :, -1:] - aj[..., :, -2:-1]
    e = jnp.concatenate([w2, w1, aj, e1, e2], axis=-1)
    # corner 2x2 blocks: double mirror into the interior
    e = e.at[..., 0:2, 0:2].set(a[..., 1::-1, 1::-1])
    e = e.at[..., 0:2, -2:].set(a[..., 1::-1, :-3:-1])
    e = e.at[..., -2:, 0:2].set(a[..., :-3:-1, 1::-1])
    e = e.at[..., -2:, -2:].set(a[..., :-3:-1, :-3:-1])
    return e


def extend(a: jnp.ndarray, nh: int) -> jnp.ndarray:
    if nh == 1:
        return extend_h1(a)
    if nh == 2:
        return extend_h2(a)
    raise ValueError(f"unsupported halo width {nh}")


def extend_rmask(rmask: jnp.ndarray, bmask: bool) -> jnp.ndarray:
    """Halo-1 extension of the land/sea mask.

    With ``bmask`` the physical-boundary ring is zeroed
    (``fill_halo_2D_bmask``, mg_mpi_exchange.f90:357-391) — the outermost
    halo ring acts as land; otherwise the mirror rule applies.
    """
    if bmask:
        pad = [(0, 0)] * (rmask.ndim - 2) + [(1, 1), (1, 1)]
        return jnp.pad(rmask, pad, mode="constant", constant_values=0.0)
    return extend_h1(rmask)
