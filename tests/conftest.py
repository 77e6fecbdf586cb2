"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Mirrors the reference's CI strategy (SURVEY.md §4) adapted for accelerator
development: unit tests use synthetic arrays + brute-force oracles; sharding
tests use a virtual multi-device CPU mesh so multi-chip code paths compile and
execute without real hardware.
"""

import os

# jax may already be imported when this runs (a plugin or sitecustomize), so
# env vars alone can be too late — update jax config directly before any
# backend initialization.  Tests run on a virtual 8-device CPU mesh: fast,
# deterministic, and exercises multi-device sharding.  What only the GPU can
# show is checked by chip_smoke.py on the card.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except AttributeError:  # older jax: XLA_FLAGS fallback above applies
    pass

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)
