"""Where the solve runs, and which of its paths may run there.

Every platform decision of the package goes through this module:

  - :func:`kernel_allowed` answers "may the Pallas color-update kernel run
    here".  The kernel is compiled for CUDA GPUs through Triton; on any
    other platform the solver takes the plain XLA paths, unless a test asks
    explicitly for interpret mode (``SolverConfig.pallas_interpret``).  No
    path falls back silently: a kernel that is selected and fails, fails.
  - :func:`default_dtype` picks the solve precision a driver uses when none
    is given: float64 (the reference's precision) on the host CPU, float32
    on an accelerator.
  - :func:`require_gpu` is the entry check of the chip benchmarks: they
    measure the card and refuse to run anywhere else.
  - :func:`enable_compile_cache` points JAX's persistent compilation cache
    at a fixed directory inside the checkout, unless
    ``JAX_COMPILATION_CACHE_DIR`` already names one.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

# the checkout root (parent of the package directory): the compile cache
# lives at a fixed path under it, so a second run finds the first's entries
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def is_host(platform: str) -> bool:
    """True for the host CPU backend."""
    return platform == "cpu"


def kernel_allowed(platform: str, cfg) -> bool:
    """May the Pallas color-update kernel run for arrays on ``platform``?

    Yes on a CUDA GPU for float32 solves when ``cfg.pallas_kernel`` is on
    (float64 stays on XLA there).  Yes for any dtype when
    ``cfg.pallas_interpret`` asks for interpret mode (the CPU tests).  No
    otherwise: the plain XLA path serves every other platform."""
    if not cfg.pallas_kernel:
        return False
    if cfg.pallas_interpret:
        return True
    return platform == "gpu" and jnp.dtype(cfg.dtype).itemsize == 4


def default_dtype(platform: str) -> str:
    """Solve precision when none is given: the reference's float64 on the
    host CPU, float32 on an accelerator."""
    return "float64" if is_host(platform) else "float32"


def require_gpu():
    """The default device, which must be a GPU; raises otherwise (chip
    benchmarks never fall back to the CPU)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU found (default device: {dev.platform}); "
                         "this script measures the card and runs nowhere "
                         "else")
    return dev


def card_info():
    """``name, power.limit`` of the first NVIDIA card as nvidia-smi gives
    them, or None where there is no nvidia-smi (the numbers a chip run
    reports are only comparable at the same power limit)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    other directory is set here.  Otherwise the cache goes to
    ``<checkout>/.jax_cache`` — a fixed path, so a later run of the same
    program hits the entries of an earlier one."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
