"""Benchmark drivers — the reference's three built programs
(``testseamount``, ``testrndtopo``, ``testcuc``; src/Makefile.am:30-33)
as runnable modules:

    python -m mgroms_jax.drivers.seamount [--nx 64 ...]
    python -m mgroms_jax.drivers.rndtopo
    python -m mgroms_jax.drivers.cuc [--data cuc_nhgrd.nc]
"""
