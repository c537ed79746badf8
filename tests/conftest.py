import os

# Tests run on CPU with 8 virtual devices (multi-chip sharding is validated
# on a simulated mesh, per the reference's "small MPI runs on one node"
# strategy — SURVEY.md section 4) and float64 enabled (the reference is a
# double-precision solver).  The card-only tests (marker ``gpu``) run on a
# GPU host with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
