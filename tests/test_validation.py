"""Input-validation gates.

The reference silently misbehaves on these inputs: non-COLA windows divide
by a near-zero gain (zaf.py:241), odd MDCT windows are floored (zaf.py:1029),
wrong-shape filterbanks die inside a matmul. Every public entry point must
raise a clear ValueError instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import zaftpu
from zaftpu.core.windows import hamming, vorbis

WIN = hamming(256)
SIG = np.random.default_rng(0).standard_normal(4096)


def test_step_larger_than_window_rejected():
    with pytest.raises(ValueError, match="step_length"):
        zaftpu.stft(SIG, WIN, 512)


def test_step_zero_rejected():
    with pytest.raises(ValueError, match="step_length"):
        zaftpu.stft(SIG, WIN, 0)


def test_f16_input_rejected():
    with pytest.raises(ValueError, match="float32/float64"):
        zaftpu.stft(SIG.astype(np.float16), WIN, 128)


def test_int_input_rejected():
    with pytest.raises(ValueError, match="float32/float64"):
        zaftpu.dct(np.arange(16), 2)


def test_empty_signal_rejected():
    with pytest.raises(ValueError, match="at least one sample"):
        zaftpu.stft(np.zeros(0), WIN, 128)


def test_non_1d_window_rejected():
    with pytest.raises(ValueError, match="1-D"):
        zaftpu.stft(SIG, np.ones((16, 16)), 8)


def test_istft_real_input_rejected():
    with pytest.raises(ValueError, match="complex"):
        zaftpu.istft(np.ones((256, 10)), WIN, 128)


def test_istft_non_cola_window_rejected():
    """A window whose decimated sum is ~0 must raise, not amplify garbage."""
    bad = np.zeros(256)
    bad[1] = 1.0  # sum(bad[::128]) == 0
    spec = zaftpu.stft(SIG, WIN, 128)
    with pytest.raises(ValueError, match="COLA"):
        zaftpu.istft(spec, bad, 128)


def test_mdct_odd_window_rejected():
    with pytest.raises(ValueError, match="even"):
        zaftpu.mdct(SIG, np.ones(255))


def test_imdct_window_length_mismatch_rejected():
    coeffs = zaftpu.mdct(SIG, vorbis(256))
    with pytest.raises(ValueError, match="2\\*number_frequencies"):
        zaftpu.imdct(coeffs, vorbis(512))


def test_imdct_1d_input_rejected():
    with pytest.raises(ValueError, match="number_times"):
        zaftpu.imdct(np.ones(128), vorbis(256))


def test_melspectrogram_wrong_filterbank_shape_rejected():
    fbank = zaftpu.melfilterbank(8000, 512, 20)  # (20, 256) — wrong for WIN
    with pytest.raises(ValueError, match="mel_filterbank"):
        zaftpu.melspectrogram(SIG, WIN, 128, fbank)


def test_mfcc_coefficient_range_rejected():
    fbank = zaftpu.melfilterbank(8000, 256, 20)
    with pytest.raises(ValueError, match="number_coefficients"):
        zaftpu.mfcc(SIG, WIN, 128, fbank, 20)  # only 19 usable (0th dropped)


def test_cqt_too_short_signal_rejected():
    kern = zaftpu.cqtkernel(8000, 12, 110.0, 880.0)
    with pytest.raises(ValueError, match="too short"):
        zaftpu.cqtspectrogram(np.zeros(10), 8000, 25, kern)


def test_validation_works_inside_user_jit():
    """Checks are shape/dtype-only, so they fire (and pass) under tracing."""
    import jax

    @jax.jit
    def fn(x):
        return zaftpu.stft(x, WIN, 128)

    out = fn(SIG.astype(np.float32))
    assert out.shape[0] == 256

    @jax.jit
    def bad(x):
        return zaftpu.stft(x, WIN, 512)

    with pytest.raises(ValueError, match="step_length"):
        bad(SIG.astype(np.float32))


def test_valid_calls_still_work():
    spec = zaftpu.stft(SIG, WIN, 128)
    rec = zaftpu.istft(spec, WIN, 128)
    assert rec.shape[-1] > 0
    coeffs = zaftpu.mdct(SIG, vorbis(256))
    assert zaftpu.imdct(coeffs, vorbis(256)).shape[-1] > 0
