"""Test environment: force CPU JAX with 8 virtual devices.

Distributed-layer tests exercise real Mesh/shard_map/all_to_all code paths on
a virtual 8-device CPU mesh; single-device tests run on the same backend for
determinism and fast compiles. The platform is set through ``jax.config`` as
well as the environment, before any backend initializes, so a machine with a
GPU still runs the suite on the CPU (``chip_smoke.py`` is the GPU check).
"""

import os

# The CPU client reads this at creation; conftest runs before any jax use.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    from jax._src import xla_bridge as _xb

    if _xb.backends_are_initialized():  # pragma: no cover - defensive
        from jax.extend.backend import clear_backends

        clear_backends()
except Exception:  # pragma: no cover
    pass

assert jax.default_backend() == "cpu", jax.default_backend()
assert len(jax.devices()) == 8, jax.devices()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
