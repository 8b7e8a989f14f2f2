"""WAV I/O round trips, normalization parity, and display smoke tests."""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest

from zaftpu import (
    cqtchromshow,
    cqtspecshow,
    melspecshow,
    mfccshow,
    sigplot,
    specshow,
    wavread,
    wavwrite,
)
from zaftpu.viz.display import amplitude_to_db


def test_wav_int16_normalization(tmp_path):
    import scipy.io.wavfile

    path = tmp_path / "i16.wav"
    data = np.array([[-32768, 32767], [0, 16384]], dtype=np.int16)
    scipy.io.wavfile.write(path, 44100, data)
    signal, sr = wavread(path)
    assert sr == 44100
    # int16 scaled by 2^15 (reference zaf.py:1202 contract).
    np.testing.assert_allclose(signal,
                               data.astype(np.float64) / 32768.0)


def test_wav_float_passthrough_roundtrip(tmp_path):
    path = tmp_path / "f32.wav"
    rng = np.random.default_rng(1)
    data = rng.uniform(-1, 1, (1000, 2)).astype(np.float32)
    wavwrite(data, 22050, path)
    signal, sr = wavread(path)
    assert sr == 22050
    np.testing.assert_allclose(signal, data, atol=1e-7)


def test_wav_reference_fixture_if_present():
    import os

    fixture = "/root/reference/audio_file.wav"
    if not os.path.exists(fixture):
        pytest.skip("reference fixture not mounted")
    signal, sr = wavread(fixture)
    assert sr == 44100
    assert signal.shape == (1014301, 2)  # SURVEY.md fixture facts
    assert np.abs(signal).max() <= 1.0


def test_amplitude_to_db_floor():
    out = amplitude_to_db(np.array([0.0, 1.0, 10.0]))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[1:], [0.0, 20.0])


def test_display_smoke(golden, signal):
    import matplotlib.pyplot as plt

    sigplot(signal, 44100)
    plt.clf()
    specshow(np.abs(golden["stft"][1:1025]), len(signal), 44100)
    plt.clf()
    melspecshow(golden["melspectrogram"], len(signal), 44100, 2048)
    plt.clf()
    mfccshow(golden["mfcc"], len(signal), 44100)
    plt.clf()
    cqtspecshow(golden["cqtspectrogram"], 25, 24, 55)
    plt.clf()
    cqtchromshow(golden["cqtchromagram"], 25)
    plt.close("all")


