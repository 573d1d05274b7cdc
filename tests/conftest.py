"""Test configuration: run on a virtual 8-device CPU mesh with float64.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``); sharding correctness is
validated on 8 virtual CPU devices (``xla_force_host_platform_device_count``)
with 1-device vs N-device equivalence tests (SURVEY.md §4 "multi-node
testing").  The GPU path is exercised by ``chip_smoke.py``.

Note: a pytest plugin imports jax before this conftest runs, so setting
JAX_PLATFORMS in os.environ alone is too late — the jax config must be
updated explicitly (the backend itself initializes lazily, so this still
takes effect).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (default tier skips them so "
             "`pytest -q` stays under ~5 min on a 2-core host)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow tier: pass --runslow to include")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
