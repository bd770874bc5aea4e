"""Test configuration: CPU-only JAX with 8 virtual devices + float64.

Tests exercise the multi-device sharding paths on a virtual CPU mesh
(no GPU is assumed; code that needs one runs in chip_smoke.py) and use
float64 for bit-parity checks against the reference's long-double math.
"""

import os

# the tests run on the CPU, whatever the machine has
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["PANGENIE_TPU_PLATFORM"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)
