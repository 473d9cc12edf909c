"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Multi-device sharding tests run on a forced-host-device CPU mesh per
SURVEY.md §4 (no pod required); compat-mode numerics need x64.
"""

import os

# The card lane (tests marked ``gpu``) keeps the accelerator backend; it is
# selected by JEICYBOO_GPU_TESTS=1 and documented in the README.
GPU_LANE = os.environ.get("JEICYBOO_GPU_TESTS", "").lower() not in ("", "0", "false", "no")

if not GPU_LANE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not GPU_LANE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
# Persistent compile cache: XLA compiles dominate test wall-clock on CPU.
from jeicyboodsp_tpu.utils.runtime import setup_compile_cache  # noqa: E402

setup_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260817)


def snr_db(ref, test):
    """SNR of `test` against reference signal `ref`, in dB."""
    ref = np.asarray(ref, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    err = ref - test
    p_sig = np.sum(ref ** 2)
    p_err = np.sum(err ** 2)
    if p_err == 0:
        return np.inf
    return 10.0 * np.log10(p_sig / p_err)


@pytest.fixture(scope="session")
def snr():
    return snr_db
