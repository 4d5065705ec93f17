"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-chip sharding is validated on host CPU devices
(xla_force_host_platform_device_count); GPU execution is exercised by
chip_smoke.py and bench.py on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: full-session operating-point floors (deselect with -m 'not slow')")
