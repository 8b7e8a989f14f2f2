"""Checks that need the card: the GPU compilations of the precision-critical
paths. Marked ``gpu``; they skip where JAX has no GPU. Run them on a card
with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``
(chip_smoke.py's parity and dials phases run the same checks end to end).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import zaftpu
from zaftpu.core import policy
from zaftpu.core.windows import hamming

pytestmark = pytest.mark.gpu


def _snr(ref, est):
    err = np.asarray(est, np.float64) - ref
    return 10 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(np.abs(err) ** 2))


def test_bf16_dot_is_native_in_gpu_program(gpu_device):
    """The bf16 dot compiles as a bf16 x bf16 -> f32 GPU dot (no f32
    emulation) and computes the exact products of the rounded operands."""
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((256, 512)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((512, 128)), jnp.bfloat16)
    hlo = jax.jit(policy.bf16_dot).lower(a, b).as_text()
    assert "bf16" in hlo and "f32" in hlo
    got = np.asarray(policy.bf16_dot(a, b))
    ref = np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    assert _snr(ref, got) > 120.0


def test_f32_operator_matmul_is_not_tf32(gpu_device):
    """The f32 operator GEMM keeps f32 accuracy (TF32 would give ~60 dB)."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((512, 2048)).astype(np.float32)
    b = rng.standard_normal((2048, 256)).astype(np.float32)
    got = np.asarray(policy.operator_matmul(jnp.asarray(a), jnp.asarray(b)))
    assert _snr(a.astype(np.float64) @ b.astype(np.float64), got) > 120.0


@pytest.mark.parametrize("engine", ["native", "matmul"])
def test_stft_round_trip_on_gpu(gpu_device, engine, monkeypatch):
    monkeypatch.setenv("ZAFTPU_FFT", engine)
    x = np.random.default_rng(2).standard_normal(44100 * 5).astype(
        np.float32)
    win = hamming(2048).astype(np.float32)
    spec = zaftpu.stft(x, win, 1024)
    assert spec.devices() == {gpu_device}
    rec = np.asarray(zaftpu.istft(spec, win, 1024))
    assert _snr(x.astype(np.float64), rec[:len(x)]) > 96.0
