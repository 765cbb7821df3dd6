"""Test environment: CPU backend with 8 virtual devices and fp64 enabled.

The reference validates everything in double precision (symmetry tests at
1e-10 relative, Source/HDK_TestGeometricMultigrid.cpp:1225); we do the same
on the CPU backend.  Multi-device sharding logic is exercised on 8 simulated
host devices (SURVEY.md section 4).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
# Force CPU even where a GPU is present: the tests check numerics at
# small sizes (on-card checks live in chip_smoke.py).  jax may already
# have been imported before this conftest runs, so mutate jax.config
# directly rather than only the environment: unit tests need fp64 + 8
# virtual devices.
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
