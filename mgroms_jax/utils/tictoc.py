"""Per-(level, section) wall-clock profiler.

The JAX equivalent of ``src/mg_tictoc.f90``: the reference accumulates
``system_clock`` deltas and call counts in a (level x subroutine) table
(:10-16) bracketed by tic/toc calls, and dumps a per-rank table
(``print_tictoc``, :114-153).

On an accelerator, wall-clocking device work requires a sync, so ``tic``/``toc`` here
block on outstanding work only when ``sync=True`` (default off inside jitted
regions, where XLA owns scheduling — use ``jax.profiler`` traces for kernel-
level timing; this table times host-visible phases like the reference's
per-level accounting).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import jax


class TicToc:
    def __init__(self):
        # (level, name) -> [accumulated seconds, calls]
        self.table: Dict[Tuple[int, str], list] = defaultdict(lambda: [0.0, 0])
        self._open: Dict[Tuple[int, str], float] = {}

    def tic(self, lev: int, name: str, sync: bool = False) -> None:
        if sync:
            (jax.effects_barrier
             if hasattr(jax, "effects_barrier") else lambda: None)()
        self._open[(lev, name)] = time.perf_counter()

    def toc(self, lev: int, name: str, sync: bool = False) -> None:
        t = time.perf_counter()
        key = (lev, name)
        t0 = self._open.pop(key, None)
        if t0 is None:
            return
        entry = self.table[key]
        entry[0] += t - t0
        entry[1] += 1

    def report(self) -> str:
        """Per-level time/call table (print_tictoc, mg_tictoc.f90:114-153)."""
        names = sorted({k[1] for k in self.table})
        levs = sorted({k[0] for k in self.table})
        out = ["level  " + "".join(f"{n:>22s}" for n in names)]
        for lev in levs:
            row = [f"{lev:5d}  "]
            for n in names:
                t, c = self.table.get((lev, n), (0.0, 0))
                row.append(f"{t:12.4f}s/{c:6d}x  " if c else " " * 22)
            out.append("".join(row))
        return "\n".join(out)

    def reset(self) -> None:
        self.table.clear()
        self._open.clear()


_GLOBAL = TicToc()


def tic(lev: int, name: str) -> None:
    _GLOBAL.tic(lev, name)


def toc(lev: int, name: str) -> None:
    _GLOBAL.toc(lev, name)


def print_tictoc() -> None:
    print(_GLOBAL.report())


def reset_tictoc() -> None:
    _GLOBAL.reset()


# -- per-level cycle profiling (the reference's per-(level,routine) table) --

# the sections the reference brackets per level (mg_relax.f90:128,146,167,
# 188; mg_solvers.f90:45,82,108,124), in this codebase's op vocabulary
_PROFILED_OPS = ("relax", "residual", "residual_restrict", "restrict",
                 "prolong", "to_state", "to_full",
                 "relax_residual", "relax_residual_restrict")


class InstrumentedBackend:
    """Profiling wrapper around any solver backend: brackets every
    per-level operation with tic/toc (blocking on the result, so each
    entry is an honest eager wall-clock) and optionally records the call
    list for steady-state re-timing (:func:`profile_fcycle`).

    The cycle functions take the backend as an argument, so running
    ``fcycle(InstrumentedBackend(be), ...)`` OUTSIDE jit executes each
    per-level op as its own dispatch — the eager diagnostic mode that
    populates the reference-style table (print_tictoc,
    mg_tictoc.f90:114-153)."""

    def __init__(self, inner, tictoc: Optional[TicToc] = None,
                 record: bool = False):
        self._inner = inner
        self._tt = tictoc if tictoc is not None else _GLOBAL
        self._record = record
        self.calls = []          # (op, lev, args, kwargs)

    def __getattr__(self, name):
        if name in _PROFILED_OPS:
            inner_fn = getattr(self._inner, name)

            def f(lev, *args, **kw):
                self._tt.tic(lev, name)
                out = inner_fn(lev, *args, **kw)
                jax.block_until_ready(out)
                self._tt.toc(lev, name)
                if self._record:
                    # record SHAPES, not arrays: keeping real argument
                    # arrays alive across the whole eager F-cycle holds
                    # every intermediate in HBM simultaneously (OOM at
                    # CUC scale); the re-timing only needs correctly
                    # shaped/typed inputs (the ops are data-independent)
                    spec = jax.tree_util.tree_map(
                        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype)
                        if isinstance(a, jax.Array) else a, (args, kw))
                    self.calls.append((name, lev) + spec)
                return out

            return f
        return getattr(self._inner, name)


def _device_time_call(backend, op: str, lev: int, args, kw,
                      iters: int) -> float:
    """Seconds per call of ``getattr(backend, op)(lev, *args, **kw)``
    measured in steady state (utils/timing.time_device_fn).  Array leaves
    ride in
    the carry; static leaves (ints, bools) stay in the closure."""
    from .timing import time_device_fn
    import jax.numpy as jnp
    leaves, treedef = jax.tree_util.tree_flatten((args, kw))
    is_arr = [isinstance(l, (jax.Array, jax.ShapeDtypeStruct))
              for l in leaves]
    # recorded calls carry ShapeDtypeStructs (tictoc records shapes, not
    # arrays — see InstrumentedBackend); materialize ones for timing
    arrs = [jnp.ones(l.shape, l.dtype)
            if isinstance(l, jax.ShapeDtypeStruct) else l
            for l, f in zip(leaves, is_arr) if f]
    static = [None if f else l for l, f in zip(leaves, is_arr)]

    def rebuild(arrs_now):
        it = iter(arrs_now)
        full = [next(it) if f else s
                for s, f in zip(static, is_arr)]
        return jax.tree_util.tree_unflatten(treedef, full)

    a0, k0 = rebuild(arrs)
    out0 = getattr(backend, op)(lev, *a0, **k0)
    # index of the first float input leaf: one element of it is
    # perturbed from the previous output each iteration, so every call
    # DEPENDS on the one before (the calls run back to back, not
    # overlapped or elided)
    fi = next((i for i, a in enumerate(arrs)
               if jnp.issubdtype(a.dtype, jnp.floating)), None)

    def step(c, be):
        arrs_c, out = c
        if fi is not None:
            lo = jax.tree_util.tree_leaves(out)[0]
            eps = (lo.ravel()[0] * 1e-30).astype(arrs_c[fi].dtype)
            arrs_c = list(arrs_c)
            arrs_c[fi] = arrs_c[fi].at[
                (0,) * arrs_c[fi].ndim].add(eps)
        a, k = rebuild(arrs_c)
        return (arrs_c, getattr(be, op)(lev, *a, **k))

    return time_device_fn(step, (list(arrs), out0), iters=iters,
                          args=(backend,))


def profile_fcycle(backend, b, cfg, device_timer: bool = False,
                   iters: int = 10, tictoc: Optional[TicToc] = None
                   ) -> TicToc:
    """Populate the per-(level, section) table with ONE F-cycle's work —
    the image of the reference's per-level profile (tic/toc
    inside Fcycle/Vcycle/relax, printed by print_tictoc).

    Runs the F-cycle eagerly through an :class:`InstrumentedBackend` (each
    per-level op bracketed + blocked).  With ``device_timer=True`` every
    distinct (op, level, signature) is then re-timed in steady state and
    the table's seconds are replaced (per-call time x eager call count) —
    use this on accelerators, where one eager call is mostly dispatch and
    compilation.  Returns the populated table."""
    from ..solver import fcycle
    tt = tictoc if tictoc is not None else _GLOBAL
    ib = InstrumentedBackend(backend, tictoc=tt, record=device_timer)
    p0 = backend.zeros(0)
    r0 = backend.residual(0, p0, b)
    jax.block_until_ready(r0)
    p = fcycle(ib, p0, b, r0, cfg)
    # the outer loop's per-iteration residual (mg_solvers.f90:65)
    ib.residual(0, p, b)
    del p, p0, r0
    if device_timer:
        # free the eager pass's products before re-timing: HBM at CUC
        # scale cannot hold them alongside a timed op's working set
        import gc
        gc.collect()
        # keep the eager call counts; replace seconds with steady-state
        # per-call times (grouped by op/level/static signature)
        groups = {}
        for op, lev, args, kw in ib.calls:
            statics = tuple(a for a in args
                            if not isinstance(a, (jax.Array,
                                                  jax.ShapeDtypeStruct))) \
                + tuple(sorted(kw.items()))
            # shapes distinguish groups too (same op/statics may run at
            # different layouts, e.g. full-array vs QuadField state)
            shapes = tuple(
                (l.shape, str(l.dtype))
                for l in jax.tree_util.tree_leaves((args, kw))
                if isinstance(l, (jax.Array, jax.ShapeDtypeStruct)))
            key = (op, lev, statics, shapes)
            if key not in groups:
                groups[key] = [0, (args, kw)]
            groups[key][0] += 1
        for key in list(tt.table):
            if key[1] in _PROFILED_OPS:
                tt.table[key][0] = 0.0
        for (op, lev, _, _), (count, (args, kw)) in groups.items():
            per_call = _device_time_call(backend, op, lev, args, kw, iters)
            tt.table[(lev, op)][0] += per_call * count
    return tt
