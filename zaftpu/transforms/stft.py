"""Short-time Fourier transform and its inverse.

Semantics match the reference (zaf.py:45-243): identical centering pad,
frame-count formula, full-complex ``(window_length, number_times)`` output
with DC and mirrored bins, COLA-normalized inverse. The implementation is a
different program entirely:

* frames are materialized frames-major ``(T, WL)`` from K contiguous slice
  views (no Python loop, no strided FFT axis — the reference's axis-0 FFT over
  a ``(WL, T)`` array is what collapses it to 88 frames/s on 1-hour audio,
  BASELINE.md);
* the forward FFT is a single batched ``rfft`` with the mirrored half
  reconstructed by conjugate symmetry (half the FFT work of zaf.py:139);
* the inverse overlap-add is a closed-form sum of K shifted block views
  instead of the sequential loop at zaf.py:227-233.

Everything is jit-compiled with shapes static per (N, WL, step) combination;
dtype follows the input (float32 on the accelerator, float64 for CPU parity
runs).
"""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp
import numpy as np

from zaftpu.core.dispatch import zjit
from zaftpu.core import fft as _fft
from zaftpu.core import frame as _frame
from zaftpu.core import validate as _validate


@partial(zjit, static_argnames=("step_length",))
def _stft_frames_half(audio_signal: jnp.ndarray, window_function: jnp.ndarray,
                      step_length: int) -> jnp.ndarray:
    """Windowed frames -> rfft, frames-major ``(T, WL//2+1)``.

    Shared by :func:`stft` and the mel/MFCC features, which only consume the
    non-mirrored bins and therefore skip the full-spectrum reconstruction.
    """
    n = audio_signal.shape[-1]
    wl = window_function.shape[0]
    pad_front, pad_back, t = _frame.stft_padding(n, wl, step_length)
    padded = jnp.pad(audio_signal, [(0, 0)] * (audio_signal.ndim - 1)
                     + [(pad_front, pad_back)])
    return _fft.windowed_frames_rfft(padded, window_function, wl,
                                     step_length, t)


@partial(zjit, static_argnames=("step_length",))
def _stft_full(audio_signal, window_function, step_length):
    half = _stft_frames_half(audio_signal, window_function, step_length)
    # Mirror by conjugate symmetry, then one complex transpose to the
    # reference's bins-major layout.
    full = _fft.full_from_half(half, window_function.shape[0])
    return jnp.swapaxes(full, -1, -2)


def _resolve_analysis_args(window_function, step_length, config, like_dtype):
    """Resolve the (window, step) pair from either positional arguments or a
    :class:`zaftpu.config.StftConfig`-style ``config`` (which wins must be
    unambiguous). A config-derived window is cast to the float dtype matching
    ``like_dtype`` so the dtype-follows-input policy holds (an f64 host
    window must not promote an f32 run)."""
    if config is not None:
        if window_function is not None or step_length is not None:
            raise ValueError(
                "pass either (window_function, step_length) or config=, "
                "not both")
        dt = np.dtype(like_dtype)
        real = (np.empty(0, dt).real.dtype
                if np.issubdtype(dt, np.inexact) else np.dtype(np.float64))
        return (config.window_array().astype(real), config.step_length)
    if window_function is None or step_length is None:
        raise ValueError(
            "window_function and step_length are required when no config= "
            "is given")
    return window_function, step_length


def stft(audio_signal, window_function=None, step_length: int | None = None,
         *, config=None):
    """Short-time Fourier transform.

    Inputs:
        audio_signal: real signal ``(number_samples,)`` (or batched
            ``(..., number_samples)``)
        window_function: window ``(window_length,)``
        step_length: hop in samples
        config: alternatively, a :class:`zaftpu.config.StftConfig` supplying
            both (``stft(x, config=StftConfig(window_length=1024,
            step_length=512))``)
    Output:
        complex STFT ``(window_length, number_times)`` — full spectrum
        including DC and mirrored negative-frequency bins, identical layout
        and values to reference zaf.py:45-141. Batched inputs return
        ``(..., window_length, number_times)``.

    The whole transform is one jitted device program (a single dispatch).
    """
    from zaftpu.utils.devcache import as_device_constant

    audio_signal = _validate.check_signal(jnp.asarray(audio_signal))
    window_function, step_length = _resolve_analysis_args(
        window_function, step_length, config, audio_signal.dtype)
    window_function = _validate.check_window(as_device_constant(window_function))
    step_length = _validate.check_step(step_length,
                                       window_function.shape[0])
    return _stft_full(audio_signal, window_function, step_length)


@partial(zjit, static_argnames=("step_length", "gain"))
def _istft_core(audio_stft: jnp.ndarray, step_length: int,
                gain: float) -> jnp.ndarray:
    wl = audio_stft.shape[-2]
    # Synthesis takes the spectra bins-major (their natural layout): the
    # Hermitian fold runs along the major axis and the COLA gain division
    # (zaf.py:241, a host-side float64 scalar of the window) is folded into
    # the inverse operator on the engine path.
    signal = _fft.synthesis_ola(audio_stft, step_length, gain)
    # Trim the centering pad (zaf.py:236-238).
    edge = wl - step_length
    return signal[..., edge:signal.shape[-1] - edge]


def istft(audio_stft, window_function=None, step_length: int | None = None,
          *, config=None):
    """Inverse short-time Fourier transform.

    Inputs:
        audio_stft: complex STFT ``(window_length, number_times)`` (or
            batched ``(..., window_length, number_times)``)
        window_function: the analysis window ``(window_length,)``
        step_length: hop in samples
        config: alternatively, a :class:`zaftpu.config.StftConfig`
    Output:
        real signal ``(number_times*step - window_length + step,)`` —
        same trim/normalization semantics as reference zaf.py:144-243.
        Exact reconstruction needs a COLA window (periodic, step | WL).
    """
    audio_stft = _validate.check_spectrum(jnp.asarray(audio_stft))
    window_function, step_length = _resolve_analysis_args(
        window_function, step_length, config, audio_stft.dtype)
    _validate.check_window(window_function)
    step_length = _validate.check_step(step_length, audio_stft.shape[-2])
    gain = _frame.cola_gain(np.asarray(window_function), step_length)
    _validate.check_cola(window_function, step_length, gain)
    return _istft_core(audio_stft, step_length, gain)


@partial(zjit, static_argnames=("step_length",))
def _spectrogram_core(audio_signal, window_function, step_length):
    half = _stft_frames_half(audio_signal, window_function, step_length)
    return jnp.swapaxes(jnp.abs(half[..., 1:]), -1, -2)


def spectrogram(audio_signal, window_function=None,
                step_length: int | None = None, *, config=None):
    """Magnitude spectrogram over bins ``1..WL/2`` — DC dropped, Nyquist kept.

    This is the reference's universal analysis slice
    (``abs(stft[1:WL/2+1, :])``, zaf.py:370); computed here directly from the
    rfft half-spectrum so the mirrored bins are never materialized.
    Accepts ``config=StftConfig(...)`` in place of (window, step).
    """
    from zaftpu.utils.devcache import as_device_constant

    audio_signal = _validate.check_signal(jnp.asarray(audio_signal))
    window_function, step_length = _resolve_analysis_args(
        window_function, step_length, config, audio_signal.dtype)
    window_function = _validate.check_window(as_device_constant(window_function))
    step_length = _validate.check_step(step_length, window_function.shape[0])
    return _spectrogram_core(audio_signal, window_function, step_length)
