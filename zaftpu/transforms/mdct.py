"""MDCT and inverse MDCT (TDAC), fully batched.

Same math and framing as the reference (zaf.py:984-1184): fixed 50% overlap,
``T = ceil(N/step) + 1`` frames, FFT with pre/post twiddles, caller-supplied
TDAC window (Vorbis sine slope or KBD — see ``zaftpu.core.windows``), inverse
via batched zero-padded FFT and overlap-add with the reference's
``[F : -F-1]`` trim.

Differences from the reference: it loops a per-frame FFT in the forward
direction "to avoid storing twice longer frames" (comment zaf.py:1059) — a
host-memory concern that does not apply here; both directions are single
batched FFTs over frames-major ``(T, WL)`` arrays, the twiddle multiplies are
fused elementwise ops, and the TDAC overlap-add is the closed-form
two-shifted-view sum from ``zaftpu.core.frame``.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from zaftpu.core.dispatch import zjit
from zaftpu.core import fft as _fft
from zaftpu.core import frame as _frame
from zaftpu.core import validate as _validate


@lru_cache(maxsize=32)
def _forward_twiddles(window_length: int):
    """Pre/post twiddles of the forward MDCT (reference zaf.py:1047-1056)."""
    wl = window_length
    f = wl // 2
    pre = np.exp(-1j * np.pi / wl * np.arange(wl))
    post = np.exp(-1j * np.pi / wl * (f + 1) * np.arange(0.5, f + 0.5))
    return pre, post


@lru_cache(maxsize=32)
def _inverse_twiddles(number_frequencies: int):
    """Pre/post twiddles of the inverse MDCT (reference zaf.py:1138-1156)."""
    f = number_frequencies
    pre = np.exp(-1j * np.pi / (2 * f) * (f + 1) * np.arange(f))
    post = np.exp(
        -1j * np.pi / (2 * f) * np.arange(0.5 + f / 2, 2 * f + f / 2 + 0.5)
    ) / f
    return pre, post


@lru_cache(maxsize=16)
def _direct_forward_matrix(window_length: int):
    """The whole per-frame forward MDCT as one real ``(WL, WL/2)`` matrix.

    ``coeffs[k] = Re(post[k] * FFT(frames_w * pre)[k])`` is linear in the
    windowed frame, so the pre-twiddle, FFT, post-twiddle and real part fold
    into ``M[t, k] = Re(pre[t] * post[k] * exp(-2pi i tk/WL))`` — the MDCT
    becomes a single ``(T, WL) @ (WL, WL/2)`` GEMM (the matmul engine's
    direct mode; reference chain zaf.py:1047-1071). float64 host math.
    """
    wl = window_length
    f = wl // 2
    pre, post = _forward_twiddles(wl)
    tk = (np.arange(wl)[:, None] * np.arange(f)[None, :]) % wl
    ang = np.exp((-2j * np.pi / wl) * tk)
    return np.real(pre[:, None] * ang * post[None, :])


@lru_cache(maxsize=16)
def _direct_inverse_matrix(number_frequencies: int):
    """The per-frame inverse MDCT (before windowing) as one real
    ``(F, 2F)`` matrix: ``frames[t] = 2*Re(post[t] * FFT_pad(coeffs *
    pre)[t])`` folds to ``M[k, t] = 2*Re(pre[k] * post[t] *
    exp(-2pi i kt/(2F)))`` (reference chain zaf.py:1138-1170)."""
    f = number_frequencies
    pre, post = _inverse_twiddles(f)
    kt = (np.arange(f)[:, None] * np.arange(2 * f)[None, :]) % (2 * f)
    ang = np.exp((-2j * np.pi / (2 * f)) * kt)
    return 2.0 * np.real(pre[:, None] * ang * post[None, :])


@zjit
def _mdct_direct_core(audio_signal: jnp.ndarray,
                      window_function: jnp.ndarray) -> jnp.ndarray:
    from zaftpu.core.policy import real_matmul

    wl = window_function.shape[0]
    step = wl // 2
    n = audio_signal.shape[-1]
    t = int(np.ceil(n / step)) + 1
    padded = jnp.pad(audio_signal, [(0, 0)] * (audio_signal.ndim - 1)
                     + [(step, (t + 1) * step - n)])
    frames = _frame.windowed_frames(padded, window_function, wl, step, t)
    # Trace-time constant: XLA owns the operator's layout and folds it into
    # the GEMM.
    rdtype = np.float32 if frames.dtype == jnp.float32 else np.float64
    matrix = jnp.asarray(_direct_forward_matrix(wl).astype(rdtype))
    coeffs = real_matmul(frames, matrix.astype(frames.dtype))
    return jnp.swapaxes(coeffs, -1, -2)


@lru_cache(maxsize=16)
def _direct_inverse_windowed_matrix(number_frequencies: int,
                                    window_bytes: bytes):
    """:func:`_direct_inverse_matrix` with the TDAC window folded into its
    columns: ``(coeffs @ M) * win == coeffs @ (M * win)``, so the separate
    post-GEMM elementwise pass over the ``(T, 2F)`` frame matrix
    disappears. float64 host math; keyed by window content so the lru
    identity is stable and the static ``wbytes`` jit key maps 1:1 to the
    operator."""
    win = np.frombuffer(window_bytes, dtype=np.float64)
    return _direct_inverse_matrix(number_frequencies) * win[None, :]


@partial(zjit, static_argnames=("wbytes",))
def _imdct_direct_core(audio_mdct: jnp.ndarray, wbytes) -> jnp.ndarray:
    from zaftpu.core.policy import real_matmul

    f = audio_mdct.shape[-2]
    coeffs = jnp.swapaxes(audio_mdct, -1, -2)  # (..., T, F) frames-major
    # The window-folded (F, 2F) inverse operator as a trace-time constant
    # (keyed by the static window bytes): XLA owns its layout and folds it
    # into the GEMM.
    rdtype = np.float32 if coeffs.dtype == jnp.float32 else np.float64
    matrix = jnp.asarray(
        _direct_inverse_windowed_matrix(f, wbytes).astype(rdtype))
    frames = real_matmul(coeffs, matrix.astype(coeffs.dtype))
    signal = _frame.overlap_add(frames, f)
    return signal[..., f:signal.shape[-1] - f - 1]


@zjit
def _imdct_direct_core_unfused(audio_mdct: jnp.ndarray,
                               window_function: jnp.ndarray) -> jnp.ndarray:
    """Traced/device-resident windows (jit or grad w.r.t. the window, or a
    window living on the device) cannot be folded into the host-built
    operator — keep the differentiable post-GEMM multiply for those."""
    from zaftpu.core.policy import real_matmul

    f = audio_mdct.shape[-2]
    coeffs = jnp.swapaxes(audio_mdct, -1, -2)
    rdtype = np.float32 if coeffs.dtype == jnp.float32 else np.float64
    matrix = jnp.asarray(_direct_inverse_matrix(f).astype(rdtype))
    frames = real_matmul(coeffs, matrix.astype(coeffs.dtype))
    frames = frames * window_function.astype(frames.dtype)
    signal = _frame.overlap_add(frames, f)
    return signal[..., f:signal.shape[-1] - f - 1]


def _host_window_bytes(window_function):
    """float64 bytes of a host-side window, or None when the window is a
    tracer or a device array (folding would break differentiation or cost a
    device->host fetch per call)."""
    if isinstance(window_function, (jax.core.Tracer, jax.Array)):
        return None
    return np.ascontiguousarray(
        np.asarray(window_function, dtype=np.float64)).tobytes()


@zjit
def _mdct_core(audio_signal: jnp.ndarray, window_function: jnp.ndarray,
               pre: jnp.ndarray, post: jnp.ndarray) -> jnp.ndarray:
    wl = window_function.shape[0]
    step = wl // 2
    n = audio_signal.shape[-1]
    t = int(np.ceil(n / step)) + 1
    # Pad `step` front and to (T+1)*step total behind (zaf.py:1036-1041).
    padded = jnp.pad(audio_signal, [(0, 0)] * (audio_signal.ndim - 1)
                     + [(step, (t + 1) * step - n)])
    frames = _frame.windowed_frames(padded, window_function, wl, step, t)
    spectra = _fft.fft(frames * pre.astype(jnp.result_type(frames, pre)))
    coeffs = jnp.real(spectra[..., :step] * post)
    return jnp.swapaxes(coeffs, -1, -2)


def _resolve_mdct_window(window_function, config, like_dtype):
    """Window from positional arg or :class:`zaftpu.config.MdctConfig`
    (cast to the float dtype matching ``like_dtype`` so the
    dtype-follows-input policy holds)."""
    if config is not None:
        if window_function is not None:
            raise ValueError(
                "pass either window_function or config=, not both")
        dt = np.dtype(like_dtype)
        real = (np.empty(0, dt).real.dtype
                if np.issubdtype(dt, np.inexact) else np.dtype(np.float64))
        return config.window_array().astype(real)
    if window_function is None:
        raise ValueError("window_function is required when no config= is "
                         "given")
    return window_function


def mdct(audio_signal, window_function=None, *, config=None):
    """Modified discrete cosine transform.

    Inputs:
        audio_signal: real signal ``(number_samples,)`` (or batched
            ``(..., number_samples)``)
        window_function: TDAC window ``(window_length,)`` — e.g.
            ``zaftpu.core.windows.vorbis`` (zaf.py:1100) or ``kbd``
            (zaf.py:1004-1010)
        config: alternatively, a :class:`zaftpu.config.MdctConfig`
    Output:
        MDCT ``(window_length/2, number_times)`` with
        ``number_times = ceil(N/(WL/2)) + 1`` — reference zaf.py:984-1075
        semantics.
    """
    from zaftpu.utils.devcache import as_device_constant, device_constant

    audio_signal = _validate.check_signal(jnp.asarray(audio_signal))
    window_function = _resolve_mdct_window(window_function, config,
                                           audio_signal.dtype)
    window_function = as_device_constant(
        _validate.check_window(window_function, even=True))
    wl = window_function.shape[0]
    if _fft.direct_engine_enabled(wl):
        return _mdct_direct_core(audio_signal, window_function)
    pre, post = _forward_twiddles(wl)
    ctype = np.complex64 if audio_signal.dtype == jnp.float32 else np.complex128
    return _mdct_core(audio_signal, window_function,
                      device_constant(pre, ctype),
                      device_constant(post, ctype))


@zjit
def _imdct_core(audio_mdct: jnp.ndarray, window_function: jnp.ndarray,
                pre: jnp.ndarray, post: jnp.ndarray) -> jnp.ndarray:
    f = audio_mdct.shape[-2]
    coeffs = jnp.swapaxes(audio_mdct, -1, -2)  # (..., T, F) frames-major
    ctype = jnp.result_type(coeffs, pre)
    # Zero-padded length-2F FFT of the pre-twiddled coefficients, batched
    # over all frames (reference zaf.py:1159-1163).
    spectra = _fft.fft(coeffs * pre.astype(ctype), n=2 * f)
    frames = 2.0 * jnp.real(spectra * post) * window_function.astype(
        jnp.real(spectra).dtype)
    signal = _frame.overlap_add(frames, f)
    # Reference trim is [step : -step-1] — one sample shorter than the
    # padded length on the right (zaf.py:1182).
    return signal[..., f:signal.shape[-1] - f - 1]


def imdct(audio_mdct, window_function=None, *, config=None):
    """Inverse MDCT with time-domain aliasing cancellation.

    Inputs:
        audio_mdct: MDCT ``(number_frequencies, number_times)`` (or batched
            ``(..., F, T)``)
        window_function: the TDAC analysis window ``(2*F,)``
        config: alternatively, a :class:`zaftpu.config.MdctConfig`
    Output:
        real signal ``(F*(number_times+1) - 2F - 1,)`` — reference
        zaf.py:1078-1184 semantics (perfect reconstruction up to rounding for
        TDAC windows).
    """
    from zaftpu.utils.devcache import as_device_constant, device_constant

    audio_mdct = jnp.asarray(audio_mdct)
    if audio_mdct.ndim < 2:
        raise ValueError(
            f"audio_mdct must be (number_frequencies, number_times), "
            f"got shape {audio_mdct.shape}")
    window_function = _resolve_mdct_window(window_function, config,
                                           audio_mdct.dtype)
    _validate.check_window(window_function, even=True)
    wlen = np.shape(window_function)[0]
    if wlen != 2 * audio_mdct.shape[-2]:
        raise ValueError(
            f"window length must be 2*number_frequencies = "
            f"{2 * audio_mdct.shape[-2]}, got {wlen}")
    f = audio_mdct.shape[-2]
    if _fft.direct_engine_enabled(2 * f):
        wbytes = _host_window_bytes(window_function)
        if wbytes is None:
            return _imdct_direct_core_unfused(
                audio_mdct, as_device_constant(window_function))
        return _imdct_direct_core(audio_mdct, wbytes)
    pre, post = _inverse_twiddles(f)
    ctype = np.complex64 if audio_mdct.dtype == jnp.float32 else np.complex128
    return _imdct_core(audio_mdct, as_device_constant(window_function),
                       device_constant(pre, ctype),
                       device_constant(post, ctype))
