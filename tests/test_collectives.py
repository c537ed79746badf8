"""Compiled-communication contract of the explicit shard_map backend.

The reference's communication budget is precise: one 8-direction halo
exchange per smoother color (mg_relax.f90:181), ALLREDUCE only for norms,
agglomeration collectives only at the de-shard level.  These tests pin the
XLA-compiled equivalents so a regression (e.g. GSPMD inserting resharding
all-to-alls, or halo exchange degenerating into all-gathers) fails loudly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from mgroms_jax import NHModel, SolverConfig
from mgroms_jax.cases.seamount import setup_seamount
from mgroms_jax.parallel import make_mesh
from mgroms_jax.parallel.exchange import halo_extend

needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 virtual devices")


def _compiled_text(f, *args):
    return jax.jit(f).lower(*args).compile().as_text()


@needs8
def test_halo_extend_compiles_to_permutes_only():
    """One halo extension = neighbour shifts (collective-permute), never an
    all-gather/all-reduce/all-to-all."""
    mesh = make_mesh(4, 2)
    x = jnp.zeros((3, 8, 16))
    f = jax.shard_map(halo_extend, mesh=mesh,
                      in_specs=(P(None, "py", "px"),),
                      out_specs=P(None, "py", "px"))
    txt = _compiled_text(f, x)
    assert "collective-permute" in txt
    assert "all-gather" not in txt
    assert "all-to-all" not in txt
    assert "all-reduce" not in txt


@needs8
def test_shardmap_relax_permute_budget():
    """nsweeps RB sweeps = 2 exchanges/sweep x 2 phases (x then y) —
    the reference's halo-per-color protocol (mg_relax.f90:172-184).
    The exchange lives inside the sweep fori_loop, so the compiled module
    must contain collective-permutes inside a while loop and no
    agglomeration collectives at a sharded level."""
    m = NHModel(32, 16, 8, cfg=SolverConfig())
    c = setup_seamount(32, 16, 8)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    m.distribute(4, 2, comm="shard_map")
    be = m.backend
    assert be.plan.shards[0].sharded

    def f(be, p, b):
        return be.relax(0, p, b, 3)

    p = be.zeros(0)
    b = be.zeros(0)
    txt = _compiled_text(f, be, p, b)
    assert "collective-permute" in txt
    assert "all-gather" not in txt
    assert "all-to-all" not in txt


@needs8
def test_norm_is_one_allreduce():
    m = NHModel(32, 16, 8, cfg=SolverConfig())
    c = setup_seamount(32, 16, 8)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    m.distribute(4, 2, comm="shard_map")
    be = m.backend

    def f(be, x):
        return be.norm_sq(0, x)

    txt = _compiled_text(f, be, be.zeros(0))
    assert txt.count("all-reduce") >= 1
    assert "all-to-all" not in txt


@needs8
def test_deshard_transition_is_one_allgather():
    """restrict at the agglomeration level: sharded fine residual ->
    replicated coarse RHS must lower to ONE fan-in collective — the
    reference's MPI_ALLGATHER (mg_gather.f90:47).  XLA may emit it as
    all-gather or as zero-pad + all-reduce (same traffic class); what must
    NOT appear is all-to-all resharding chatter."""
    m = NHModel(32, 16, 8, cfg=SolverConfig())
    c = setup_seamount(32, 16, 8)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    m.distribute(4, 2, comm="shard_map")
    be = m.backend
    # level 1 (16x8 on 4x2 -> local 4x4 < nsmall) must be replicated
    assert not be.plan.shards[1].sharded

    def f(be, r):
        return be.restrict(0, r)

    txt = _compiled_text(f, be, be.zeros(0))
    assert ("all-gather" in txt) or ("all-reduce" in txt)
    assert "all-to-all" not in txt
