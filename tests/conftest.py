"""Test environment.

The suite runs on the CPU with a simulated 8-device mesh: multi-device
sharding paths are validated on virtual CPU devices
(``--xla_force_host_platform_device_count``).  A run selecting the card
tests (``pytest -m gpu tests/test_gpu.py``) leaves the platform to JAX;
those tests skip inside a fixture when no GPU is present.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ahocorasick_tpu.utils import compile_cache  # noqa: E402

compile_cache.configure()


def pytest_configure(config):
    if config.option.markexpr == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
