"""Numpy Fortran-transliteration pin for the operator assembly.

Transliterates ``define_matrix`` (mg_define_matrix.f90:211-680) — cw
conductances, the k=1 / interior / k=nz band loops including the
``bmask`` cross terms, the pre-diagonal halo mirror, and the
row-sum diagonal — directly from the Fortran text, independently of the
library's vectorized slicing, and pins ``assembly.assemble_bands``
against it on every entry the Fortran writes.

Index conventions: Fortran j, i ∈ [0, ny+1] extended (cA, dx, dy, cw),
zr/zw carry a 2-halo (j ∈ [-1, ny+2] → python jj = j+1).  python
k == Fortran k-1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

hlf, qrt, one = 0.5, 0.25, 1.0


def _np_define_matrix(dx, dy, zr, zw, rmask, use_bmask):
    """define_matrix in numpy: returns cA[8, nz, ny+2, nx+2] with NaN in
    never-written slots, plus cw.  ``dx``/``dy``/``rmask`` are (ny+2,
    nx+2) (F j,i ∈ [0, ny+1]); ``zr`` (nz, ny+4, nx+4) / ``zw`` (nz+1,
    ny+4, nx+4) carry the 2-halo (F j ∈ [-1, ny+2] → jj = j+1)."""
    nz = zr.shape[0]
    ny, nx = dx.shape[0] - 2, dx.shape[1] - 2

    ZR = lambda k, j, i: zr[k - 1, j + 1, i + 1]
    ZW = lambda k, j, i: zw[k - 1, j + 1, i + 1]
    DX = lambda j, i: dx[j, i]
    DY = lambda j, i: dy[j, i]

    # umask/vmask (mg_define_matrix.f90:259-280)
    umask = np.ones((ny + 2, nx + 2))
    vmask = np.ones((ny + 2, nx + 2))
    if use_bmask:
        umask[:] = 0.0
        vmask[:] = 0.0
        for i in range(1, nx + 2):
            for j in range(0, ny + 2):
                umask[j, i] = rmask[j, i - 1] * rmask[j, i]
        for i in range(0, nx + 2):
            for j in range(1, ny + 2):
                vmask[j, i] = rmask[j - 1, i] * rmask[j, i]
    UM = lambda j, i: umask[j, i]
    VM = lambda j, i: vmask[j, i]

    # cw (:309-336)
    cw = np.empty((nz + 1, ny + 2, nx + 2))
    for i in range(0, nx + 2):
        for j in range(0, ny + 2):
            Arz = DX(j, i) * DY(j, i)
            k = 1
            cw[k - 1, j, i] = (Arz / (ZR(k, j, i) - ZW(k, j, i))) * (
                one
                + (hlf * (ZW(k, j, i + 1) - ZW(k, j, i - 1)) / DX(j, i)) ** 2
                + (hlf * (ZW(k, j + 1, i) - ZW(k, j - 1, i)) / DY(j, i)) ** 2)
            for k in range(2, nz + 1):
                cw[k - 1, j, i] = (Arz / (ZR(k, j, i) - ZR(k - 1, j, i))) * (
                    one
                    + (hlf * (ZW(k, j, i + 1) - ZW(k, j, i - 1))
                       / DX(j, i)) ** 2
                    + (hlf * (ZW(k, j + 1, i) - ZW(k, j - 1, i))
                       / DY(j, i)) ** 2)
            k = nz + 1
            cw[k - 1, j, i] = (Arz / (ZW(k, j, i) - ZR(k - 1, j, i))) * (
                one
                + (hlf * (ZW(k, j, i + 1) - ZW(k, j, i - 1)) / DX(j, i)) ** 2
                + (hlf * (ZW(k, j + 1, i) - ZW(k, j - 1, i)) / DY(j, i)) ** 2)
    CW = lambda k, j, i: cw[k - 1, j, i]

    cA = np.full((8, nz, ny + 2, nx + 2), np.nan)

    def setA(n, k, j, i, v):
        cA[n - 1, k - 1, j, i] = v

    def A(n, k, j, i):
        return cA[n - 1, k - 1, j, i]

    # ---- k = 1 (:352-487) ----
    k = 1
    for i in range(1, nx + 1):
        for j in range(1, ny + 2):
            setA(3, k, j, i, qrt * (
                (hlf * (ZR(k + 1, j + 1, i) - ZR(k + 1, j - 1, i))
                 / DY(j, i)) * DX(j, i)
                + (hlf * (ZR(k, j, i) - ZR(k, j - 2, i))
                   / DY(j - 1, i)) * DX(j - 1, i)) * VM(j, i))
            v4 = ((qrt * (ZW(k + 1, j, i) - ZW(k, j, i)
                          + ZW(k + 1, j - 1, i) - ZW(k, j - 1, i))
                   * (DX(j, i) + DX(j - 1, i)))
                  / (hlf * (DY(j, i) + DY(j - 1, i)))
                  - (((hlf * (ZR(k, j + 1, i) - ZR(k, j - 1, i))
                       / DY(j, i)) * DX(j, i)) ** 2
                     / (CW(k, j, i) + CW(k + 1, j, i))
                     + ((hlf * (ZR(k, j, i) - ZR(k, j - 2, i))
                         / DY(j - 1, i)) * DX(j - 1, i)) ** 2
                     / (CW(k, j - 1, i) + CW(k + 1, j - 1, i)))
                  - qrt * ((hlf * (ZR(k, j, i) - ZR(k, j - 2, i))
                            / DY(j - 1, i)) * DX(j - 1, i)
                           - (hlf * (ZR(k, j + 1, i) - ZR(k, j - 1, i))
                              / DY(j, i)) * DX(j, i)))
            if use_bmask:
                v4 = (v4
                      - (hlf
                         * ((hlf * (ZR(k, j - 1, i + 1) - ZR(k, j - 1, i - 1))
                             / DX(j - 1, i)) * DY(j - 1, i))
                         * ((hlf * (ZR(k, j, i) - ZR(k, j - 2, i))
                             / DY(j - 1, i)) * DX(j - 1, i))
                         / (CW(k, j - 1, i) + CW(k + 1, j - 1, i))
                         * (UM(j - 1, i + 1) - UM(j - 1, i))
                         - hlf
                         * ((hlf * (ZR(k, j, i + 1) - ZR(k, j, i - 1))
                             / DY(j, i)) * DX(j, i))
                         * ((hlf * (ZR(k, j + 1, i) - ZR(k, j - 1, i))
                             / DY(j, i)) * DX(j, i))
                         / (CW(k, j, i) + CW(k + 1, j, i))
                         * (UM(j, i + 1) - UM(j, i)))) * VM(j, i)
            else:
                v4 = v4  # vmask == 1 everywhere; Fortran multiplies the
                # topo expression by vmask only in the bmask branch
            setA(4, k, j, i, v4)
    for i in range(1, nx + 2):
        for j in range(1, ny + 1):
            setA(6, k, j, i, qrt * (
                (hlf * (ZR(k + 1, j, i + 1) - ZR(k + 1, j, i - 1))
                 / DX(j, i)) * DY(j, i)
                + (hlf * (ZR(k, j, i) - ZR(k, j, i - 2))
                   / DX(j, i - 1)) * DY(j, i - 1)) * UM(j, i))
            v7 = ((qrt * (ZW(k + 1, j, i) - ZW(k, j, i)
                          + ZW(k + 1, j, i - 1) - ZW(k, j, i - 1))
                   * (DY(j, i) + DY(j, i - 1)))
                  / (hlf * (DX(j, i) + DX(j, i - 1)))
                  - (((hlf * (ZR(k, j, i + 1) - ZR(k, j, i - 1))
                       / DX(j, i)) * DY(j, i)) ** 2
                     / (CW(k, j, i) + CW(k + 1, j, i))
                     + ((hlf * (ZR(k, j, i) - ZR(k, j, i - 2))
                         / DX(j, i - 1)) * DY(j, i - 1)) ** 2
                     / (CW(k, j, i - 1) + CW(k + 1, j, i - 1)))
                  - qrt * ((hlf * (ZR(k, j, i) - ZR(k, j, i - 2))
                            / DX(j, i - 1)) * DY(j, i - 1)
                           - (hlf * (ZR(k, j, i + 1) - ZR(k, j, i - 1))
                              / DX(j, i)) * DY(j, i)))
            if use_bmask:
                v7 = (v7
                      - (hlf
                         * ((hlf * (ZR(k, j, i) - ZR(k, j, i - 2))
                             / DX(j, i - 1)) * DY(j, i - 1))
                         * ((hlf * (ZR(k, j + 1, i - 1) - ZR(k, j - 1, i - 1))
                             / DY(j, i - 1)) * DX(j, i - 1))
                         / (CW(k, j, i - 1) + CW(k + 1, j, i - 1))
                         * (VM(j + 1, i - 1) - VM(j, i - 1))
                         - hlf
                         * ((hlf * (ZR(k, j, i + 1) - ZR(k, j, i - 1))
                             / DY(j, i)) * DX(j, i))
                         * ((hlf * (ZR(k, j + 1, i) - ZR(k, j - 1, i))
                             / DY(j, i)) * DX(j, i))
                         / (CW(k, j, i) + CW(k + 1, j, i))
                         * (VM(j + 1, i) - VM(j, i)))) * UM(j, i)
            setA(7, k, j, i, v7)
    for i in range(1, nx + 2):
        for j in range(0, ny + 1):
            setA(5, k, j, i,
                 + hlf
                 * ((hlf * (ZR(k, j + 1, i + 1) - ZR(k, j + 1, i - 1))
                     / DX(j + 1, i)) * DY(j + 1, i))
                 * ((hlf * (ZR(k, j + 2, i) - ZR(k, j, i))
                     / DY(j + 1, i)) * DX(j + 1, i))
                 / (CW(k, j + 1, i) + CW(k + 1, j + 1, i))
                 * UM(j + 1, i) * VM(j + 1, i)
                 + hlf
                 * ((hlf * (ZR(k, j, i) - ZR(k, j, i - 2))
                     / DX(j, i - 1)) * DY(j, i - 1))
                 * ((hlf * (ZR(k, j + 1, i - 1) - ZR(k, j - 1, i - 1))
                     / DY(j, i - 1)) * DX(j, i - 1))
                 / (CW(k, j, i - 1) + CW(k + 1, j, i - 1))
                 * UM(j, i) * VM(j + 1, i - 1))
    for i in range(1, nx + 2):
        for j in range(1, ny + 2):
            setA(8, k, j, i,
                 - hlf
                 * ((hlf * (ZR(k, j - 1, i + 1) - ZR(k, j - 1, i - 1))
                     / DX(j - 1, i)) * DY(j - 1, i))
                 * ((hlf * (ZR(k, j, i) - ZR(k, j - 2, i))
                     / DY(j - 1, i)) * DX(j - 1, i))
                 / (CW(k, j - 1, i) + CW(k + 1, j - 1, i))
                 * UM(j - 1, i) * VM(j, i)
                 - hlf
                 * ((hlf * (ZR(k, j, i) - ZR(k, j, i - 2))
                     / DX(j, i - 1)) * DY(j, i - 1))
                 * ((hlf * (ZR(k, j + 1, i - 1) - ZR(k, j - 1, i - 1))
                     / DY(j, i - 1)) * DX(j, i - 1))
                 / (CW(k, j, i - 1) + CW(k + 1, j, i - 1))
                 * UM(j, i) * VM(j, i - 1))

    # ---- k = 2..nz-1 (:491-561) ----
    for i in range(1, nx + 1):
        for j in range(1, ny + 1):
            for k in range(2, nz):
                v2 = CW(k, j, i)
                if use_bmask:
                    v2 = (v2
                          - qrt * ((hlf * (ZR(k - 1, j, i + 1)
                                           - ZR(k - 1, j, i - 1))
                                    / DX(j, i)) * DY(j, i)
                                   - (hlf * (ZR(k, j, i + 1)
                                             - ZR(k, j, i - 1))
                                      / DX(j, i)) * DY(j, i))
                          * (UM(j, i + 1) - UM(j, i))
                          - qrt * ((hlf * (ZR(k - 1, j + 1, i)
                                           - ZR(k - 1, j - 1, i))
                                    / DY(j, i)) * DX(j, i)
                                   - (hlf * (ZR(k, j + 1, i)
                                             - ZR(k, j - 1, i))
                                      / DY(j, i)) * DX(j, i))
                          * (VM(j + 1, i) - VM(j, i)))
                setA(2, k, j, i, v2)
    for i in range(1, nx + 1):
        for j in range(1, ny + 2):
            for k in range(2, nz):
                setA(3, k, j, i, qrt * (
                    (hlf * (ZR(k + 1, j + 1, i) - ZR(k + 1, j - 1, i))
                     / DY(j, i)) * DX(j, i)
                    + (hlf * (ZR(k, j, i) - ZR(k, j - 2, i))
                       / DY(j - 1, i)) * DX(j - 1, i)) * VM(j, i))
                setA(4, k, j, i,
                     (qrt * (ZW(k + 1, j, i) - ZW(k, j, i)
                             + ZW(k + 1, j - 1, i) - ZW(k, j - 1, i))
                      * (DX(j, i) + DX(j - 1, i)))
                     / (hlf * (DY(j, i) + DY(j - 1, i))) * VM(j, i))
                setA(5, k, j, i, -qrt * (
                    (hlf * (ZR(k - 1, j + 1, i) - ZR(k - 1, j - 1, i))
                     / DY(j, i)) * DX(j, i)
                    + (hlf * (ZR(k, j, i) - ZR(k, j - 2, i))
                       / DY(j - 1, i)) * DX(j - 1, i)) * VM(j, i))
    for i in range(1, nx + 2):
        for j in range(1, ny + 1):
            for k in range(2, nz):
                setA(6, k, j, i, qrt * (
                    (hlf * (ZR(k + 1, j, i + 1) - ZR(k + 1, j, i - 1))
                     / DX(j, i)) * DY(j, i)
                    + (hlf * (ZR(k, j, i) - ZR(k, j, i - 2))
                       / DX(j, i - 1)) * DY(j, i - 1)) * UM(j, i))
                setA(7, k, j, i,
                     (qrt * (ZW(k + 1, j, i) - ZW(k, j, i)
                             + ZW(k + 1, j, i - 1) - ZW(k, j, i - 1))
                      * (DY(j, i) + DY(j, i - 1)))
                     / (hlf * (DX(j, i) + DX(j, i - 1))) * UM(j, i))
                setA(8, k, j, i, -qrt * (
                    (hlf * (ZR(k - 1, j, i + 1) - ZR(k - 1, j, i - 1))
                     / DX(j, i)) * DY(j, i)
                    + (hlf * (ZR(k, j, i) - ZR(k, j, i - 2))
                       / DX(j, i - 1)) * DY(j, i - 1)) * UM(j, i))

    # ---- k = nz (:565-607) ----
    k = nz
    for i in range(1, nx + 1):
        for j in range(1, ny + 1):
            setA(2, k, j, i, CW(k, j, i))
    for i in range(1, nx + 1):
        for j in range(1, ny + 2):
            setA(4, k, j, i, (
                qrt * (ZW(k + 1, j, i) - ZW(k, j, i)
                       + ZW(k + 1, j - 1, i) - ZW(k, j - 1, i))
                * (DX(j, i) + DX(j - 1, i))
                / (hlf * (DY(j, i) + DY(j - 1, i)))
                + qrt * (
                    - (hlf * (ZR(k, j, i) - ZR(k, j - 2, i))
                       / DY(j - 1, i)) * DX(j - 1, i)
                    + (hlf * (ZR(k, j + 1, i) - ZR(k, j - 1, i))
                       / DY(j, i)) * DX(j, i))) * VM(j, i))
            setA(5, k, j, i, -qrt * (
                (hlf * (ZR(k - 1, j + 1, i) - ZR(k - 1, j - 1, i))
                 / DY(j, i)) * DX(j, i)
                + (hlf * (ZR(k, j, i) - ZR(k, j - 2, i))
                   / DY(j - 1, i)) * DX(j - 1, i)) * VM(j, i))
    for i in range(1, nx + 2):
        for j in range(1, ny + 1):
            setA(7, k, j, i, (
                qrt * (ZW(k + 1, j, i) - ZW(k, j, i)
                       + ZW(k + 1, j, i - 1) - ZW(k, j, i - 1))
                * (DY(j, i) + DY(j, i - 1))
                / (hlf * (DX(j, i) + DX(j, i - 1)))
                + qrt * (
                    - (hlf * (ZR(k, j, i) - ZR(k, j, i - 2))
                       / DX(j, i - 1)) * DY(j, i - 1)
                    + (hlf * (ZR(k, j, i + 1) - ZR(k, j, i - 1))
                       / DX(j, i)) * DY(j, i))) * UM(j, i))
            setA(8, k, j, i, -qrt * (
                (hlf * (ZR(k - 1, j, i + 1) - ZR(k - 1, j, i - 1))
                 / DX(j, i)) * DY(j, i)
                + (hlf * (ZR(k, j, i) - ZR(k, j, i - 2))
                   / DX(j, i - 1)) * DY(j, i - 1)) * UM(j, i))

    # ---- bmask halo mirror (:611-613; physical-edge Neumann fill) ----
    if use_bmask:
        for n in range(2, 9):
            a = cA[n - 1]
            a[:, 0, :] = a[:, 1, :]
            a[:, -1, :] = a[:, -2, :]
            a[:, :, 0] = a[:, :, 1]
            a[:, :, -1] = a[:, :, -2]

    # ---- diagonal = negative row sum (:615-657) ----
    for i in range(1, nx + 1):
        for j in range(1, ny + 1):
            k = 1
            setA(1, k, j, i,
                 - A(2, k + 1, j, i)
                 - A(4, k, j, i) - A(4, k, j + 1, i)
                 - A(7, k, j, i) - A(7, k, j, i + 1)
                 - A(6, k, j, i) - A(8, k + 1, j, i + 1)
                 - A(3, k, j, i) - A(5, k + 1, j + 1, i)
                 - A(5, k, j, i) - A(5, k, j - 1, i + 1)
                 - A(8, k, j, i) - A(8, k, j + 1, i + 1))
            for k in range(2, nz):
                setA(1, k, j, i,
                     - A(2, k, j, i) - A(2, k + 1, j, i)
                     - A(4, k, j, i) - A(4, k, j + 1, i)
                     - A(7, k, j, i) - A(7, k, j, i + 1)
                     - A(6, k, j, i) - A(6, k - 1, j, i + 1)
                     - A(8, k, j, i) - A(8, k + 1, j, i + 1)
                     - A(3, k, j, i) - A(3, k - 1, j + 1, i)
                     - A(5, k, j, i) - A(5, k + 1, j + 1, i))
            k = nz
            setA(1, k, j, i,
                 - A(2, k, j, i)
                 - CW(k + 1, j, i)
                 + hlf * (hlf * (ZR(k, j, i + 2) - ZR(k, j, i))
                          / DX(j, i + 1)) * DY(j, i + 1)
                 - hlf * (hlf * (ZR(k, j, i) - ZR(k, j, i - 2))
                          / DX(j, i - 1)) * DY(j, i - 1)
                 + hlf * (hlf * (ZR(k, j + 2, i) - ZR(k, j, i))
                          / DY(j + 1, i)) * DX(j + 1, i)
                 - hlf * (hlf * (ZR(k, j, i) - ZR(k, j - 2, i))
                          / DY(j - 1, i)) * DX(j - 1, i)
                 - A(4, k, j, i) - A(4, k, j + 1, i)
                 - A(7, k, j, i) - A(7, k, j, i + 1)
                 - A(6, k - 1, j, i + 1)
                 - A(8, k, j, i)
                 - A(3, k - 1, j + 1, i)
                 - A(5, k, j, i))
    return cA, cw


def _grids(nz, ny, nx, seed=0):
    """Random smooth-ish terrain-following grids with positive spacings,
    on the extended shapes assemble_bands takes."""
    rng = np.random.default_rng(seed)
    dx = rng.uniform(50.0, 150.0, (ny + 2, nx + 2))
    dy = rng.uniform(50.0, 150.0, (ny + 2, nx + 2))
    # zw: nz+1 strictly increasing levels per column, with a 2-halo
    base = -rng.uniform(800.0, 1500.0, (ny + 4, nx + 4))
    incr = rng.uniform(5.0, 40.0, (nz + 1, ny + 4, nx + 4))
    zw = base[None] + np.cumsum(incr, axis=0) - incr[0:1]
    zr = 0.5 * (zw[1:] + zw[:-1])
    rmask = (rng.uniform(size=(ny + 2, nx + 2)) > 0.2).astype(float)
    rmask[0, :] = rmask[-1, :] = rmask[:, 0] = rmask[:, -1] = 0.0
    return dx, dy, zr, zw, rmask


@pytest.mark.parametrize("use_bmask", [False, True])
def test_assemble_bands_matches_fortran_transliteration(use_bmask):
    from mgroms_jax.assembly import assemble_bands
    nz, ny, nx = 5, 6, 7
    dx, dy, zr, zw, rmask = _grids(nz, ny, nx)
    op = assemble_bands(jnp.asarray(dx), jnp.asarray(dy),
                        jnp.asarray(zr), jnp.asarray(zw),
                        jnp.asarray(rmask), use_bmask)
    ours = np.asarray(op.cA)
    ref, _ = _np_define_matrix(dx, dy, zr, zw, rmask, use_bmask)
    written = ~np.isnan(ref)
    assert written.any()
    for n in range(8):
        w = written[n]
        np.testing.assert_allclose(
            ours[n][w], ref[n][w], rtol=1e-12, atol=1e-12,
            err_msg=f"band cA{n + 1} (bmask={use_bmask})")


if __name__ == "__main__":
    pytest.main([__file__, "-q"])
