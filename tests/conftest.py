"""Test harness configuration.

Runs the engine on the CPU backend with 8 virtual devices so multi-device
sharding tests work without accelerators (chip_smoke.py runs the GPU path;
__graft_entry__.py dry-runs the SPMD path). Mirrors the reference's Mtest
philosophy (testing/Mtest.py.in): every test runs against a fresh in-process
engine, results diffed against exact expected values.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"
# isolate tests from the machine-wide expand-capacity memo (retry-count
# assertions must see the cold path) and the XLA AOT cache
os.environ.setdefault("MTPU_EXPAND_MEMO", "0")
os.environ.setdefault("MTPU_COMPILE_CACHE", "0")

import jax  # noqa: E402

# JAX reads JAX_PLATFORMS when it is first imported; a plugin may have
# imported it before this file ran
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
