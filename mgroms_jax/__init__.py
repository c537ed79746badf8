"""mgroms_jax — geometric multigrid in JAX for the nonhydrostatic
pressure Poisson equation on terrain-following ocean grids.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
Fortran+MPI reference CESR-lab/mgroms: variable-coefficient 15-point
sigma-coordinate Laplacian, F-cycles of V-cycles with red-black line-in-z
relaxation, divergence RHS and velocity projection, 2-D horizontal domain
decomposition over a device mesh.
"""

from .config import SolverConfig, read_namelist            # noqa: F401
from .levels import build_level_plan, find_grid_levels     # noqa: F401
from .model import NHModel                                 # noqa: F401
from .solver import SingleDeviceBackend, solve_p, fcycle, vcycle  # noqa: F401

__version__ = "0.1.0"
