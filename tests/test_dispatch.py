"""Trace-coherent env-flag dispatch.

Every ``ZAFTPU_*`` flag consulted at trace time must take effect when flipped
*between* two calls of the same shape: :func:`zaftpu.core.dispatch.zjit` keys
its trace caches on the :class:`zaftpu.config.DispatchConfig` snapshot, so a
flip retraces instead of silently reusing the stale program. These tests
observe the retrace directly (counters on the engine entry points the new
trace must — or must not — call) rather than inferring it from numerics.
"""

import numpy as np
import pytest

import zaftpu
from zaftpu.config import DispatchConfig
from zaftpu.core import fft as fft_mod
from zaftpu.core import policy as policy_mod
from zaftpu.core.windows import hamming

SR, WL, STEP = 44100, 2048, 1024


@pytest.fixture(scope="module")
def x32():
    return np.random.default_rng(7).standard_normal(SR).astype(np.float32)


@pytest.fixture()
def win32():
    return hamming(WL).astype(np.float32)


def _count_calls(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(name)
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def test_dispatch_config_snapshots_env(monkeypatch):
    monkeypatch.setenv("ZAFTPU_FFT", "native")
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    cfg = DispatchConfig.current()
    assert cfg.fft == "native" and cfg.precision == "split4"
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    assert DispatchConfig.current().fft == "matmul"


def test_dispatch_config_sees_compute_dtype_context():
    assert DispatchConfig.current().matmul_dtype == ""
    with zaftpu.compute_dtype("bfloat16"):
        assert DispatchConfig.current().matmul_dtype == "bfloat16"
    assert DispatchConfig.current().matmul_dtype == ""


def test_fft_engine_flip_retraces(x32, win32, monkeypatch):
    """matmul -> native -> matmul: each flip must change which FFT
    implementation the (same-shape) trace calls, and the flip back must
    reuse the earlier engine trace without re-entering Python."""
    calls = _count_calls(monkeypatch, fft_mod, "direct_rfft")

    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    a = np.asarray(zaftpu.stft(x32, win32, STEP))
    n_engine = len(calls)
    assert n_engine >= 1  # engine trace went through direct_rfft

    monkeypatch.setenv("ZAFTPU_FFT", "native")
    b = np.asarray(zaftpu.stft(x32, win32, STEP))
    assert len(calls) == n_engine  # native trace never touched the engine

    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    c = np.asarray(zaftpu.stft(x32, win32, STEP))
    assert len(calls) == n_engine  # warm engine trace reused, no retrace

    # The two engines legitimately round differently in f32; the flip-back
    # reproduces the first result up to CPU-threadpool reduction-order noise
    # (separate executions of one executable are not bitwise-stable on the
    # CPU runtime — see tests/test_determinism.py's escape hatch).
    scale = float(np.abs(a).max())
    np.testing.assert_allclose(a, c, rtol=2e-6, atol=4e-6 * scale)
    assert not np.array_equal(a, b)


def test_precision_flip_retraces(x32, win32, monkeypatch):
    """highest -> split4 on the same shape must re-route the operator GEMM
    through the manual 4-pass scheme (and back)."""
    calls = _count_calls(monkeypatch, policy_mod, "_split4_matmul")
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")  # engine path on CPU

    monkeypatch.setenv("ZAFTPU_PRECISION", "highest")
    a = np.asarray(zaftpu.stft(x32, win32, STEP))
    assert len(calls) == 0

    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    b = np.asarray(zaftpu.stft(x32, win32, STEP))
    assert len(calls) >= 1  # split4 trace entered the manual scheme

    monkeypatch.setenv("ZAFTPU_PRECISION", "highest")
    c = np.asarray(zaftpu.stft(x32, win32, STEP))
    scale = float(np.abs(a).max())
    np.testing.assert_allclose(a, c, rtol=2e-6, atol=4e-6 * scale)
    assert not np.array_equal(a, b)


def test_compute_dtype_context_flip_retraces(x32, monkeypatch):
    """Entering compute_dtype("bfloat16") between two same-shape CQT calls
    must lower the operator matmuls (different values); the block default
    is 1024 for both dtypes since round 4 (cqt_roofline.json)."""
    from zaftpu.transforms import cqt as cqt_mod

    kern = zaftpu.cqtkernel(SR, 24, 55.0, 3520.0)
    ref = np.asarray(zaftpu.cqtspectrogram(x32, SR, 25, kern))
    assert cqt_mod._block_frames() == 1024
    with zaftpu.compute_dtype("bfloat16"):
        assert cqt_mod._block_frames() == 1024
        got = np.asarray(zaftpu.cqtspectrogram(x32, SR, 25, kern))
    assert not np.array_equal(ref, got)
    again = np.asarray(zaftpu.cqtspectrogram(x32, SR, 25, kern))
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(ref, again, rtol=2e-6, atol=4e-6 * scale)


def test_cqt_block_env_flip_takes_effect(monkeypatch):
    """ZAFTPU_CQT_BLOCK is read per call (was read once at import before)."""
    from zaftpu.transforms import cqt as cqt_mod

    monkeypatch.setenv("ZAFTPU_CQT_BLOCK", "64")
    assert cqt_mod._block_frames() == 64
    monkeypatch.delenv("ZAFTPU_CQT_BLOCK")
    assert cqt_mod._block_frames() == 1024


def test_zjit_preserves_signature_statics(x32, win32):
    """Positional static args (step_length) must still bind through the
    signature-extended shim."""
    from zaftpu.core.frame import stft_padding

    out = zaftpu.stft(x32, win32, STEP)
    t = stft_padding(SR, WL, STEP)[2]
    assert out.shape == (WL, t) and out.dtype == np.complex64


