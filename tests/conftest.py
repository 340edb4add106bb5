"""Test configuration: by default everything runs on the CPU, as 8
virtual devices.

The sharding tests need several devices; XLA's host platform provides
them. Tests that need a GPU carry the ``gpu`` marker and take the
``gpu`` fixture, which skips them on any other platform. On a machine
with a card, ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` runs
them there.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu():
    """The GPU device for a ``gpu``-marked test; skips without one."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform}")
    return dev
