"""Mel filterbank, mel spectrogram, and MFCCs.

The filterbank is a parameter-only precompute built on host in float64 with
construction math identical to the reference (zaf.py:279-321: mel edges
rounded to integer FFT bins *before* triangle construction, left/right
`linspace` ramps with the reference's -1 start offsets, minimum mel evaluated
at one FFT bin — not 0 Hz). Unlike the reference, which stores it CSR and
densifies it on *every* call (zaf.py:373,445), the build keeps it dense from
the start: at (n_mels, WL/2) = (40, 1024) scale one dense GEMM is the
natural device formulation.

MFCC's DCT-II over the mel axis (reference: ``scipy.fftpack.dct(axis=0,
norm="ortho")``, zaf.py:443-449) is applied as a precomputed orthonormal
DCT-II matrix matmul — a (M, M) x (M, T) product.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax.numpy as jnp
import numpy as np

from zaftpu.core.dispatch import zjit
from zaftpu.core import policy as _policy
from zaftpu.core import validate as _validate
from zaftpu.transforms.stft import _stft_frames_half

# Matches np.finfo(float).eps used by the reference at zaf.py:445 regardless
# of the on-device compute dtype.
_LOG_EPS = float(np.finfo(np.float64).eps)


def hertz_to_mel(frequency):
    """``mel(f) = 2595*log10(1 + f/700)`` (reference zaf.py:280-281)."""
    return 2595.0 * np.log10(1.0 + np.asarray(frequency, dtype=np.float64) / 700.0)


def mel_to_hertz(mel):
    """Inverse mel scale ``700*(10^(m/2595) - 1)`` (reference zaf.py:291-294)."""
    return 700.0 * (np.power(10.0, np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=64)
def _melfilterbank_cached(sampling_frequency: int, window_length: int,
                          number_mels: int) -> np.ndarray:
    # Mel range: from one FFT bin (sr/WL — not 0 Hz, zaf.py:280) to Nyquist.
    mel_lo = hertz_to_mel(sampling_frequency / window_length)
    mel_hi = hertz_to_mel(sampling_frequency / 2)
    # Half-overlapping triangles of constant mel width 2*(hi-lo)/(M+1)
    # (zaf.py:284-287), edges rounded to integer FFT bins before the ramps
    # are built (zaf.py:290-295).
    width = 2.0 * (mel_hi - mel_lo) / (number_mels + 1)
    edges_mel = np.arange(mel_lo, mel_hi + 1, width / 2.0)
    edges = np.round(
        mel_to_hertz(edges_mel) * window_length / sampling_frequency
    ).astype(int)

    fbank = np.zeros((number_mels, window_length // 2), dtype=np.float64)
    for m in range(number_mels):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        # Ascending then descending ramps over bin ranges [lo-1, mid) and
        # [mid-1, hi) — the -1 offsets and the mid-1 overwrite reproduce the
        # reference's construction exactly (zaf.py:301-316).
        fbank[m, lo - 1:mid] = np.linspace(0.0, 1.0, num=mid - lo + 1)
        fbank[m, mid - 1:hi] = np.linspace(1.0, 0.0, num=hi - mid + 1)
    return fbank


def melfilterbank(sampling_frequency, window_length, number_mels):
    """Mel filterbank as a dense ``(number_mels, window_length/2)`` array.

    Covers FFT bins 1..WL/2 (DC dropped, Nyquist kept — the reference's
    spectrogram slice convention, zaf.py:370). Values are bit-identical to
    ``reference melfilterbank(...).toarray()`` (zaf.py:246-321); results are
    cached per parameter tuple.
    """
    return _melfilterbank_cached(int(sampling_frequency), int(window_length),
                                 int(number_mels))


def _as_dense(mel_filterbank) -> np.ndarray:
    """Accept a dense array or any scipy.sparse matrix (drop-in parity)."""
    if hasattr(mel_filterbank, "toarray"):
        return np.asarray(mel_filterbank.toarray())
    return np.asarray(mel_filterbank)


@lru_cache(maxsize=16)
def dct_ii_ortho_matrix(size: int) -> np.ndarray:
    """Orthonormal DCT-II matrix: ``C[k,n]=s_k sqrt(2/N) cos(pi k(2n+1)/2N)``.

    Equivalent to ``scipy.fftpack.dct(eye(N), norm='ortho')`` — the MFCC
    cepstral transform (reference zaf.py:443-449) as a single matmul.
    """
    n = np.arange(size, dtype=np.float64)
    k = n[:, None]
    mat = np.sqrt(2.0 / size) * np.cos(np.pi * k * (2.0 * n[None, :] + 1.0)
                                       / (2.0 * size))
    mat[0] /= np.sqrt(2.0)
    return mat


@partial(zjit, static_argnames=("step_length",))
def _melspectrogram_core(audio_signal, window_function, fbank, step_length):
    half = _stft_frames_half(audio_signal, window_function, step_length)
    mag = jnp.abs(half[..., 1:])  # (..., T, WL/2): DC dropped, Nyquist kept
    mel = _policy.operator_matmul(mag, fbank.T)
    return jnp.swapaxes(mel, -1, -2)


def _resolve_mel_args(window_function, step_length, mel_filterbank, config,
                      like_dtype):
    """Resolve (window, step, filterbank) from positional args or a
    :class:`zaftpu.config.MelConfig` (window cast to the input's float dtype
    — dtype follows input)."""
    if config is not None:
        if (window_function is not None or step_length is not None
                or mel_filterbank is not None):
            raise ValueError(
                "pass either (window_function, step_length, mel_filterbank) "
                "or config=, not both")
        dt = np.dtype(like_dtype)
        real = (np.empty(0, dt).real.dtype
                if np.issubdtype(dt, np.inexact) else np.dtype(np.float64))
        return (config.window_array().astype(real), config.step_length,
                config.filterbank())
    if window_function is None or step_length is None or mel_filterbank is None:
        raise ValueError(
            "window_function, step_length and mel_filterbank are required "
            "when no config= is given")
    return window_function, step_length, mel_filterbank


def melspectrogram(audio_signal, window_function=None, step_length=None,
                   mel_filterbank=None, *, config=None):
    """Mel spectrogram ``(number_mels, number_times)``.

    Magnitude spectrogram x filterbank as one batched matmul (reference
    semantics zaf.py:324-375). ``mel_filterbank`` may be the dense array from
    :func:`melfilterbank` or a scipy sparse matrix; alternatively pass
    ``config=MelConfig(...)`` to derive all three parameters.
    """
    from zaftpu.utils.devcache import as_device_constant, device_constant

    audio_signal = _validate.check_signal(jnp.asarray(audio_signal))
    window_function, step_length, mel_filterbank = _resolve_mel_args(
        window_function, step_length, mel_filterbank, config,
        audio_signal.dtype)
    window_function = _validate.check_window(as_device_constant(window_function))
    step_length = _validate.check_step(step_length, window_function.shape[0])
    fbank = device_constant(
        _validate.check_filterbank(_as_dense(mel_filterbank),
                                   window_function.shape[0]),
        _policy.operator_dtype(audio_signal.dtype,
                               transform="melspectrogram"))
    return _melspectrogram_core(audio_signal, window_function, fbank,
                                step_length)


@partial(zjit, static_argnames=("step_length", "number_coefficients"))
def _mfcc_core(audio_signal, window_function, fbank, dct_mat, step_length,
               number_coefficients):
    half = _stft_frames_half(audio_signal, window_function, step_length)
    power = jnp.abs(half[..., 1:]) ** 2  # power spec (zaf.py:437-439)
    mel = _policy.operator_matmul(power, fbank.T)
    logmel = jnp.log(mel + jnp.asarray(_LOG_EPS, dtype=mel.dtype))
    cepstra = _policy.operator_matmul(logmel, dct_mat.T)
    # Keep coefficients 1..C — the 0th is dropped (zaf.py:452).
    return jnp.swapaxes(cepstra[..., 1:number_coefficients + 1], -1, -2)


def mfcc(audio_signal, window_function=None, step_length=None,
         mel_filterbank=None, number_coefficients=None, *, config=None):
    """MFCCs ``(number_coefficients, number_times)`` (reference zaf.py:378-454).

    Power spectrogram -> mel matmul -> log(+eps) -> orthonormal DCT-II along
    the mel axis -> coefficients 1..C, both matmuls on the device.
    Alternatively pass ``config=MelConfig(...)`` to derive every parameter.
    """
    from zaftpu.utils.devcache import as_device_constant, device_constant

    audio_signal = _validate.check_signal(jnp.asarray(audio_signal))
    if config is not None and number_coefficients is None:
        number_coefficients = config.number_coefficients
    window_function, step_length, mel_filterbank = _resolve_mel_args(
        window_function, step_length, mel_filterbank, config,
        audio_signal.dtype)
    if number_coefficients is None:
        raise ValueError(
            "number_coefficients is required when no config= is given")
    window_function = _validate.check_window(as_device_constant(window_function))
    step_length = _validate.check_step(step_length, window_function.shape[0])
    fbank = _validate.check_filterbank(_as_dense(mel_filterbank),
                                       window_function.shape[0])
    number_coefficients = int(number_coefficients)
    if not 1 <= number_coefficients < fbank.shape[0]:
        raise ValueError(
            f"number_coefficients must be in [1, number_mels-1="
            f"{fbank.shape[0] - 1}] (the 0th coefficient is dropped, "
            f"zaf.py:452), got {number_coefficients}")
    dct_mat = dct_ii_ortho_matrix(fbank.shape[0])
    op_dtype = _policy.operator_dtype(audio_signal.dtype, transform="mfcc")
    return _mfcc_core(audio_signal, window_function,
                      device_constant(fbank, op_dtype),
                      device_constant(dct_mat, op_dtype),
                      step_length, number_coefficients)
