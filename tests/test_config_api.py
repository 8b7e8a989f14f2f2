"""The parameter-config calling convention.

``zaftpu.config``'s frozen dataclasses are the public parameter objects:
every transform accepts ``config=XxxConfig(...)`` in place of its positional
parameters. The contract is that the config path resolves to *bit-identical
parameters* (window array, step, filterbank, kernel) — asserted directly
below — and therefore the same traced program. Output comparisons use a
one-ulp f32 tolerance rather than bitwise equality because XLA's *CPU*
threadpool reductions are not run-to-run deterministic under host load
(two executions of the very same jitted program on the very same input can
differ in the last f32 bit — see tests/test_determinism.py's documented
escape hatch).
"""

import numpy as np
import pytest

import zaftpu
from zaftpu.config import CqtConfig, MdctConfig, MelConfig, StftConfig
from zaftpu.core.windows import hamming, vorbis

SR, WL, STEP = 44100, 2048, 1024


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    # Reduction-order noise is relative to the *data scale*, not elementwise
    # (a 2048-term f32 contraction reassociated by the CPU threadpool moves
    # small outputs by ~||row|| * eps), hence the scaled atol.
    np.testing.assert_allclose(a, b, rtol=2e-6,
                               atol=4e-6 * max(1.0, float(np.abs(a).max())))


@pytest.fixture(scope="module")
def x32():
    return np.random.default_rng(3).standard_normal(SR).astype(np.float32)


@pytest.fixture(scope="module")
def x64():
    return np.random.default_rng(3).standard_normal(SR)


def test_stft_config_resolves_identical_parameters(x32):
    from zaftpu.transforms.stft import _resolve_analysis_args

    cfg = StftConfig(window_length=WL, step_length=STEP, window="hamming")
    win, step = _resolve_analysis_args(None, None, cfg, np.float32)
    assert step == STEP and win.dtype == np.float32
    np.testing.assert_array_equal(win, hamming(WL).astype(np.float32))
    # complex spectra resolve to the matching real window dtype
    win64, _ = _resolve_analysis_args(None, None, cfg, np.complex128)
    assert win64.dtype == np.float64


def test_stft_istft_config_equivalent(x32):
    cfg = StftConfig(window_length=WL, step_length=STEP, window="hamming")
    win = hamming(WL).astype(np.float32)
    ref = np.asarray(zaftpu.stft(x32, win, STEP))
    got = np.asarray(zaftpu.stft(x32, config=cfg))
    _close(ref, got)
    _close(zaftpu.istft(ref, win, STEP), zaftpu.istft(ref, config=cfg))


def test_stft_config_dtype_follows_input(x32, x64):
    """An f64 host window derived from config must not promote f32 runs."""
    cfg = StftConfig(window_length=WL, step_length=STEP)
    assert zaftpu.stft(x32, config=cfg).dtype == np.complex64
    assert zaftpu.stft(x64, config=cfg).dtype == np.complex128


def test_stft_config_conflict_rejected(x32):
    cfg = StftConfig()
    with pytest.raises(ValueError, match="not both"):
        zaftpu.stft(x32, hamming(WL), config=cfg)
    with pytest.raises(ValueError, match="required"):
        zaftpu.stft(x32)


def test_mdct_imdct_config_equivalent(x32):
    cfg = MdctConfig(window_length=WL, window="vorbis")
    win = vorbis(WL).astype(np.float32)
    np.testing.assert_array_equal(cfg.window_array().astype(np.float32), win)
    ref = np.asarray(zaftpu.mdct(x32, win))
    _close(ref, zaftpu.mdct(x32, config=cfg))
    _close(zaftpu.imdct(ref, win), zaftpu.imdct(ref, config=cfg))


def test_mel_mfcc_config_equivalent(x32):
    cfg = MelConfig(sampling_frequency=SR, window_length=WL, number_mels=40,
                    number_coefficients=20, step_length=STEP)
    win = hamming(WL).astype(np.float32)
    fbank = zaftpu.melfilterbank(SR, WL, 40)
    np.testing.assert_array_equal(cfg.filterbank(), fbank)  # same cached op
    _close(zaftpu.melspectrogram(x32, win, STEP, fbank),
           zaftpu.melspectrogram(x32, config=cfg))
    _close(zaftpu.mfcc(x32, win, STEP, fbank, 20),
           zaftpu.mfcc(x32, config=cfg))


def test_cqt_config_equivalent(x32):
    cfg = CqtConfig(sampling_frequency=SR, octave_resolution=24,
                    minimum_frequency=55.0, maximum_frequency=3520.0,
                    time_resolution=25)
    kern = zaftpu.cqtkernel(SR, 24, 55.0, 3520.0)
    assert cfg.kernel() is kern  # the cached kernel object itself
    _close(zaftpu.cqtspectrogram(x32, SR, 25, kern),
           zaftpu.cqtspectrogram(x32, config=cfg))
    _close(zaftpu.cqtchromagram(x32, SR, 25, 24, kern),
           zaftpu.cqtchromagram(x32, config=cfg))
