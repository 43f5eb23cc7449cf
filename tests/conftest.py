"""Test config: run on a virtual 8-device CPU mesh with float64 enabled.

Multi-chip sharding tests use the standard JAX fake-multi-device technique
(SURVEY.md §4): XLA_FLAGS=--xla_force_host_platform_device_count=8.
Must be set before jax initializes, hence here at conftest import time.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Persistent compile cache: the fast tier is compile-dominated (interpret
# kernels, the 5-point companion solve); repeat runs skip straight to
# execution.
from stereo_reconstruction_cv_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)

import numpy as np
import pytest


@pytest.fixture()
def rng():
    # Function-scoped: every test sees the same deterministic stream
    # regardless of suite order (a session-scoped generator made tests
    # order-dependent).
    return np.random.default_rng(0)
