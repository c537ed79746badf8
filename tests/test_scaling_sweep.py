"""Scaling-sweep contract: the explicit shard_map layer's communication
cost per F-cycle is FLAT in device count.

The reference's scaling harness (examples/perf_caparmor/nh_perf_1.sh:3-10)
sweeps mesh sizes at fixed-per-level communication structure: each rank
does the same 8-direction exchange per color regardless of how many ranks
exist (mg_mpi_exchange.f90:104-324).  The XLA equivalent: the compiled
F-cycle's collective-permute instruction count must be identical across
mesh sizes whenever the level plans shard the same levels — more devices
means more parallel links, never more serialized collectives per cycle.

examples/scaling.py sweeps this interactively (docs/scaling.md records a
committed run); these tests pin the structural invariant behind it.
"""

import jax
import pytest

from mgroms_jax import NHModel, SolverConfig
from mgroms_jax.cases.seamount import setup_seamount

needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 virtual devices")


def _fcycle_text(npx, npy, comm):
    from mgroms_jax.solver import fcycle
    m = NHModel(256, 32, 8, cfg=SolverConfig())
    c = setup_seamount(256, 32, 8)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    m.distribute(npx, npy, comm=comm)
    be = m.backend

    def f(be, p, b, r):
        return fcycle(be, p, b, r, m.cfg)

    p = be.zeros(0)
    b = be.zeros(0)
    return m, jax.jit(f).lower(be, p, b, p).compile().as_text()


@needs8
def test_shardmap_permute_count_flat_in_device_count():
    """2, 4 and 8 devices along x: every level stays sharded in all three
    plans (local nx >= nsmall throughout), so the compiled F-cycle must
    contain the SAME number of collective-permutes — communication per
    cycle is a property of the level plan, not the mesh size."""
    counts = {}
    for npx in (2, 4, 8):
        m, txt = _fcycle_text(npx, 1, "shard_map")
        assert all(s.sharded for s in m.backend.plan.shards), \
            f"plan {npx}x1 de-shards a level; test grid needs adjusting"
        # CPU lowers sync collective-permute ops; GPUs lower async
        # start/done pairs — count op openings either way
        counts[npx] = txt.count("collective-permute(") \
            + txt.count("collective-permute-start(")
        assert counts[npx] > 0
    assert counts[2] == counts[4] == counts[8], counts


@needs8
def test_scaling_sweep_runs_both_comm_layers(capsys):
    """The harness itself (examples/scaling.py) completes a small sweep on
    the virtual mesh under BOTH communication layers and reports an
    efficiency column (VERDICT: the shard_map layer must be swept too)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    import scaling
    for comm in ("gspmd", "shard_map"):
        sys.argv = ["scaling.py", "--grids", "64", "--meshes", "1x1,2x2",
                    "--nz", "8", "--comm", comm]
        scaling.main()
        out = capsys.readouterr().out
        assert f"comm={comm}" in out
        rows = [l for l in out.splitlines() if l.strip().startswith("64")]
        assert len(rows) == 2, out
        eff = float(rows[-1].split()[-1])
        assert eff > 0.0
