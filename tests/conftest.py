"""Test configuration: pin JAX to a virtual 8-device CPU mesh.

Multi-device sharding is tested without accelerators the standard JAX way:
``--xla_force_host_platform_device_count=8`` on the CPU backend.  This runs
at configure time, before any test module imports jax.
"""

import os

_FLAG = "--xla_force_host_platform_device_count=8"


def pytest_configure(config):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " " + _FLAG).strip()
    from softwarerenderer_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
