"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Parity gates run in float64 against the reference's NumPy/SciPy math (the
float64 oracle mode from SURVEY.md §4); float32 paths are gated with
accelerator-level tolerances. Sharding tests use the 8-device virtual CPU
mesh (``--xla_force_host_platform_device_count``) so multi-chip layouts are
validated without hardware.

The backend defaults to the CPU; tests marked ``gpu`` need a card and run
on one with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` (they
skip, from the ``gpu_device`` fixture, where no GPU is present).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Small length-bucketing quantum for the tiny test signals (the default 128
# frames/shard would pad 1-second fixtures to hour-bucket shapes); the
# bucketing behavior itself is gated in tests/test_bucketing.py.
os.environ.setdefault("ZAFTPU_BUCKET_FRAMES", "4")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")


@pytest.fixture(scope="session")
def golden():
    """Golden outputs generated from the reference (tests/make_golden.py)."""
    if not os.path.exists(GOLDEN_PATH):
        pytest.skip("golden fixtures missing — run tests/make_golden.py")
    return np.load(GOLDEN_PATH)


@pytest.fixture(scope="session")
def signal(golden):
    """The deterministic 1 s, 44.1 kHz test signal the goldens were made from."""
    return golden["signal"]


@pytest.fixture(scope="session")
def hamming_window():
    from zaftpu.core.windows import hamming

    return hamming(2048, periodic=True)


@pytest.fixture()
def gpu_device():
    """The first GPU device; skips the test where JAX has none (decided
    here, at run time — never while the module is imported)."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU (default backend: {device.platform})")
    return device


def snr_db(reference: np.ndarray, estimate: np.ndarray) -> float:
    """Signal-to-error ratio in dB over the common prefix."""
    n = min(len(reference), len(estimate))
    err = np.asarray(estimate[:n]) - np.asarray(reference[:n])
    return float(10.0 * np.log10(np.sum(reference[:n] ** 2) / np.sum(err ** 2)))
