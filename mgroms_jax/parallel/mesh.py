"""Device-mesh plan for the 2-D horizontal domain decomposition.

JAX equivalent of the reference's process topology
(``mg_grids.f90:580-661``: Cartesian npx x npy grid with stride-aware
neighbours).  Here the topology is a ``jax.sharding.Mesh`` with axes
('py', 'px'); data layout (nz, ny, nx) shards ny over 'py' and nx over
'px'.  z stays on-device and unsharded — the tridiagonally-coupled direction
is never partitioned, mirroring the reference's deliberate choice (z-pencil
layout, `assumptions` file).

Communication model: the solve is jitted with per-level sharding
constraints and XLA/GSPMD inserts the halo collective-permutes (NCCL on
GPUs) — the explicit-ppermute/shard_map path is an optimization layer, not
a correctness requirement.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..levels import LevelSpec, ShardSpec, build_shard_plan


def make_mesh(npx: int, npy: int,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build the (py, px) mesh.  Mirrors the reference rank layout
    ``rank = pj*npx + pi`` (mg_grids.f90:593-594): x is the fast axis."""
    devices = list(devices if devices is not None else jax.devices())
    if len(devices) < npx * npy:
        raise ValueError(f"need {npx * npy} devices, have {len(devices)}")
    grid = np.array(devices[: npx * npy]).reshape(npy, npx)
    return Mesh(grid, ("py", "px"))


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Per-level distribution schedule over a fixed mesh.

    Sharded levels carry P(None, 'py', 'px'); once the local tile would
    drop below ``nsmall`` the level is fully replicated (P()) — the
    replicate-not-idle agglomeration policy (mg_gather.f90), executed as a
    single resharding collective instead of gradual 2x2 gathers.
    """

    mesh: Mesh
    shards: tuple          # tuple[ShardSpec]

    @classmethod
    def create(cls, mesh: Mesh, levels: List[LevelSpec],
               nsmall: int = 8) -> "MeshPlan":
        npy, npx = mesh.devices.shape
        shards = tuple(build_shard_plan(levels, npx=npx, npy=npy,
                                        nsmall=nsmall))
        return cls(mesh=mesh, shards=shards)

    def spec(self, lev: int, ndim: int = 3) -> P:
        sh = self.shards[lev]
        if not sh.sharded:
            return P()
        py = "py" if sh.shard_py else None
        px = "px" if sh.shard_px else None
        return P(*([None] * (ndim - 2) + [py, px]))

    def sharding(self, lev: int, ndim: int = 3) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(lev, ndim))

    def constrain(self, lev: int, x):
        """Pin an array (or a pytree state, e.g. a quad-persistent
        QuadField) to its level's distribution (the GSPMD equivalent of the
        reference's per-level communicator choice)."""
        return jax.tree.map(
            lambda leaf: jax.lax.with_sharding_constraint(
                leaf, self.sharding(lev, leaf.ndim)), x)
