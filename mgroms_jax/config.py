"""Solver configuration — the JAX equivalent of the reference namelist system.

Reference: ``src/mg_namelist.f90`` (parameters + ``nhparam`` namelist group,
lines 11-50; reader at :55-127).  The reference reads a Fortran namelist file
``nh_namelist``; we support the same file format through
:func:`read_namelist` so that shipped configs keep working, but the primary
interface is the immutable :class:`SolverConfig` dataclass — the config is
trace-time static metadata, which is exactly what XLA wants (every flag below
changes the compiled program, never a runtime branch).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """All solver tunables (defaults match ``mg_namelist.f90:11-35``)."""

    # smallest local horizontal dimension before coarse-level agglomeration
    # (reference `nsmall`, mg_namelist.f90:11)
    nsmall: int = 8

    # smoothing schedule (mg_namelist.f90:13-15)
    ns_coarsest: int = 40
    ns_pre: int = 3
    ns_post: int = 2

    # outer-loop convergence control (mg_namelist.f90:17-18)
    solver_prec: float = 1.0e-6
    solver_maxiter: int = 50

    # 'real' keeps the extra bottom-level horizontal-diagonal couplings
    # (mg_namelist.f90:20; used at mg_relax.f90:271-276)
    cmatrix: str = "real"

    # 'GS' | 'RB' | 'FC' (mg_namelist.f90:22-25)
    relax_method: str = "RB"

    # order-exact sequential Gauss-Seidel (ops/relax.relax_gs_exact):
    # reproduces the reference's GS histories (mg_relax.f90:116-148) by
    # updating columns one at a time in its i-outer/j-inner order.  A
    # CPU/f64 parity mode — the dependency chain is fully sequential, so
    # it is orders of magnitude slower than the default simultaneous
    # column-Jacobi 'GS' sweep (the documented deviation).  GS only.
    gs_exact: bool = False

    # prolongation: 'nearest' | 'linear' (mg_namelist.f90:27)
    interp_type: str = "linear"

    # restriction: 'avg' | 'linear' (mg_namelist.f90:29)
    restrict_type: str = "avg"

    # 8:1 vertical coarsening at level 2 (mg_namelist.f90:31)
    aggressive: bool = False

    # diagnostics field dumps (mg_namelist.f90:33).  When True, assembly /
    # RHS / solve dump stage fields via io.diagnostics.write_field exactly
    # where the reference writes netCDF (nhydro.f90:85-95,130-132,
    # mg_define_matrix.f90:187-194,668-673, mg_solvers.f90:74-77)
    netcdf_output: bool = False
    # directory for the diagnostics dumps (reference writes in cwd)
    output_dir: str = "."

    # boundary land/sea mask folded into matrix coefficients
    # (mg_namelist.f90:35)
    bmask: bool = False

    # ---- extensions (no reference equivalent) ----
    # dtype for the solve. float64 reproduces the double-precision reference
    # histories; float32 is the accelerator's fast path.
    dtype: str = "float64"
    # exact z-line solver inside the smoother: 'thomas' (sequential scan,
    # matches the reference loop bit-for-bit, mg_relax.f90:308-334) or
    # 'pcr' (parallel cyclic reduction — same exact solve, log2(nz)
    # full-width vector steps; loses the f32 floor, PERF.md)
    tridiag: str = "thomas"
    # compact checkerboard storage for the RB/FC line smoother: evaluate the
    # neighbour gather + Thomas solve only on the active color's columns
    # (quad-parity arrays, ops/relax_compact.py) instead of computing every
    # column and masking — same iterates, ~half the smoother flops
    compact: bool = True
    # the Pallas color-update kernel (ops/pallas/relax_tiled.py, Triton):
    # one program per tile of quad columns walks z in registers.  Used on
    # CUDA GPUs for float32 solves (platform.kernel_allowed); the XLA
    # compact path serves everything else
    pallas_kernel: bool = True
    # run the kernel in the Pallas interpreter — the CPU tests' way to
    # exercise the kernel code paths (including inside shard_map local
    # blocks); never implied by the platform
    pallas_interpret: bool = False
    # store the smoother's gather blocks in bfloat16 with the Thomas
    # pivots rebuilt from the rounded operator so diag = -(row sum) holds
    # exactly (relax_compact.consistent_pivots); the outer loop then runs
    # in defect-correction form (solver.cycle_step) so the ~0.4% smoother
    # perturbation contracts with the error instead of flooring the
    # residual — end-to-end convergence matches f32 (tests).  Residuals
    # keep the float32 operator.  Off by default (parity mode)
    fused_bands_bf16: bool = False
    # fuse the post-sweep residual into the sweep's LAST color update
    # (quad-persistent RB levels): an exact line solve leaves
    # r = b - Dx - g with the gather the solve already computed, and the
    # opposite-color state it read does not change afterwards — so the
    # fused residual equals the fresh one exactly in exact arithmetic
    # (the boundary mirror ring and the four 'real' plane-0 same-color
    # couplings are re-evaluated fresh; the only implementation noise is
    # ~1 ulp from XLA compiling the peeled final sweep outside the
    # multi-sweep fori_loop).  Halves
    # the residual and residual+restrict passes at level 0 (each was a
    # full 16-term gather over all four target quads; now only the first
    # color's two need one).
    fused_residual: bool = True
    # coarsest-level treatment: 'relax' (ns_coarsest smoothing sweeps,
    # reference behaviour, mg_solvers.f90:117/144) or 'direct' (multiply by
    # a precomputed dense inverse — one matmul instead of ~2*ns_coarsest
    # sequential tiny-kernel launches; an exact coarse solve, so convergence
    # is at least as good per cycle)
    coarsest: str = "relax"
    # number of F-cycles fused per host-side convergence check (1 == reference
    # behaviour: one ALLREDUCE-synced residual per cycle, mg_solvers.f90:61-79)
    cycles_per_check: int = 1
    # run the whole outer convergence loop as ONE on-device lax.while_loop
    # program (solver._solve_device_loop): identical iterates + history,
    # one host sync per SOLVE instead of per cycle.  Default off (host
    # loop = reference parity incl. per-iteration verbose/netcdf hooks)
    device_loop: bool = False

    def __post_init__(self):
        if self.interp_type == "linear" and self.restrict_type == "linear":
            # mg_namelist.f90:95-98
            raise ValueError("linear interp + linear restrict is not permitted")
        if self.relax_method not in ("GS", "RB", "FC", "Gauss-Seidel",
                                     "Red-Black", "Four-Color"):
            raise ValueError(f"unknown relax_method {self.relax_method!r}")
        if self.tridiag not in ("thomas", "pcr"):
            raise ValueError(f"unknown tridiag {self.tridiag!r}")
        if self.cmatrix not in ("real", "simple"):
            raise ValueError(f"unknown cmatrix {self.cmatrix!r}")
        if self.interp_type not in ("linear", "nearest"):
            raise ValueError(f"unknown interp_type {self.interp_type!r}")
        if self.restrict_type not in ("avg", "linear"):
            raise ValueError(f"unknown restrict_type {self.restrict_type!r}")
        if self.restrict_type == "linear":
            # Parity stop: the reference ACCEPTS restrict='linear'
            # (mg_namelist.f90:29) but has no linear restriction code —
            # fine2coarse always averages (mg_intergrids.f90:16-162 has a
            # single 1/8-sum path), so the option is silently dead there.
            # We refuse instead of silently averaging.
            raise NotImplementedError(
                "restrict_type='linear' is unimplemented (the reference's "
                "namelist option is equally dead: mg_intergrids.f90 only "
                "averages); use 'avg'")

    @property
    def relax_kind(self) -> str:
        """Canonical relaxation method name: 'GS', 'RB' or 'FC'."""
        return {"Gauss-Seidel": "GS", "Red-Black": "RB",
                "Four-Color": "FC"}.get(self.relax_method, self.relax_method)


_NML_BOOL = {".true.": True, ".t.": True, "t": True,
             ".false.": False, ".f.": False, "f": False}

# namelist key -> dataclass field (identical names in the reference group,
# mg_namelist.f90:37-50)
_NML_KEYS = {
    "solver_prec", "solver_maxiter", "nsmall", "ns_coarsest", "ns_pre",
    "ns_post", "cmatrix", "relax_method", "interp_type", "restrict_type",
    "netcdf_output", "aggressive", "bmask",
}


def read_namelist(path: str, base: Optional[SolverConfig] = None) -> SolverConfig:
    """Parse a Fortran ``&nhparam`` namelist file into a :class:`SolverConfig`.

    Accepts the exact file format the reference reads
    (``mg_namelist.f90:55-127``; example in ``src/nh_namelist``).  Unknown
    keys raise; values use Fortran literal syntax (``.true.``, ``1.d-12``).
    """
    base = base or SolverConfig()
    import os
    if not os.path.exists(path):
        # the reference proceeds with defaults when the file is absent
        # (mg_namelist.f90:76-86)
        return base
    text = open(path).read()
    m = re.search(r"&nhparam(.*?)/", text, re.S | re.I)
    if not m:
        return base
    updates = {}
    for line in m.group(1).splitlines():
        line = line.split("!")[0].strip().rstrip(",")
        if not line or "=" not in line:
            continue
        key, val = (s.strip() for s in line.split("=", 1))
        key = key.lower()
        if key not in _NML_KEYS:
            raise ValueError(f"unknown nhparam key {key!r} in {path}")
        val = val.strip().strip("'\"")
        lv = val.lower()
        if lv in _NML_BOOL:
            parsed = _NML_BOOL[lv]
        else:
            try:
                parsed = int(val)
            except ValueError:
                try:
                    # Fortran double literals: 1.d-12
                    parsed = float(lv.replace("d", "e"))
                except ValueError:
                    parsed = val
        updates[key] = parsed
    return dataclasses.replace(base, **updates)
