"""Test configuration.

The suite runs on an 8-device virtual CPU platform, so sharding tests run
anywhere, with highest matmul precision for f32 fidelity. `jax.config`
pins the platform (it wins over a JAX_PLATFORMS set by the environment).

Tests that need an NVIDIA GPU carry the `gpu` marker and take the `gpu`
fixture, which decides at run time (never at import or collection) and
skips with a reason when no card answers `nvidia-smi`. They run their
GPU work in a child process, since this process stays on the CPU. On a
machine with a card:

    python -m pytest tests/ -m gpu
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped when none is present")


@pytest.fixture
def gpu():
    """The card's `nvidia-smi` name/power-limit line; skips without one."""
    from quadruped_ctrl_tpu.utils.device import card_info

    try:
        return card_info()
    except Exception as e:  # noqa: BLE001 — no nvidia-smi, or no card
        pytest.skip(f"no NVIDIA GPU: {type(e).__name__}: {e}")
