"""FFT wrappers and spectrum-layout helpers.

The reference computes full complex FFTs everywhere — it never uses ``rfft``
(SURVEY.md L0 note). The real-input transform halves the FFT work and the
memory traffic, so analysis paths here run ``rfft`` internally and
reconstruct the reference's full-spectrum convention (DC + positive +
mirrored negative bins, zaf.py:139) only at the API boundary via conjugate
symmetry.

Dtype policy: all functions follow the input dtype — float32 in (the
accelerator fast path) gives complex64 out; float64 in (CPU parity mode with
``jax_enable_x64``) gives complex128, matching the reference bit-for-bit up to
rounding.
"""

from __future__ import annotations

import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from zaftpu.core import frame as _frame


def engine_selected() -> bool:
    """Is the matmul-FFT engine the active FFT implementation?

    ``ZAFTPU_FFT`` modes:
      - ``auto`` (default) / ``native``: XLA's FFT op (``jnp.fft`` — cuFFT on
        the GPU, DUCC on the CPU), which is also the f64 parity oracle.
      - ``matmul``: the DFT-as-GEMM engine below, plain JAX a user can
        select (tests run both engines).
    """
    return os.environ.get("ZAFTPU_FFT", "auto") == "matmul"


def _use_matmul_engine(n: int) -> bool:
    """Route this power-of-two FFT through the four-step matmul engine?"""
    return engine_selected() and n >= 4 and (n & (n - 1)) == 0


def _direct_max() -> int:
    """Largest FFT length the matmul engine computes as a *direct* DFT GEMM.

    Below this size the engine skips the four-step decomposition and runs
    the DFT as one full-width matmul per (real, imag) component: the
    contraction dimension is then N (e.g. 2048 for the reference STFT
    window) instead of the four-step's sqrt(N) (32/64), at
    ~N/(5 log2 N) more FLOPs than an FFT.
    ``ZAFTPU_FFT_DIRECT_MAX`` overrides (0 disables, forcing pure
    four-step)."""
    return int(os.environ.get("ZAFTPU_FFT_DIRECT_MAX", "4096"))


def direct_engine_enabled(n: int) -> bool:
    """True when the matmul engine's direct-GEMM mode covers length ``n``
    (no power-of-two restriction, unlike the four-step path). Transforms
    whose per-frame chain folds into a single real operator matrix (MDCT's
    pre/FFT/post/Re composition) gate their fused path on this."""
    return engine_selected() and 2 <= n <= _direct_max()


def _use_direct_engine(n: int, dtype) -> bool:
    return (direct_engine_enabled(n)
            and not jnp.issubdtype(dtype, jnp.complexfloating))


def rfft(frames: jnp.ndarray, n: int | None = None) -> jnp.ndarray:
    """Real FFT along the last axis: ``(..., N)`` -> ``(..., N//2 + 1)``."""
    if n is not None and n != frames.shape[-1]:
        frames = _pad_or_trim(frames, n)
    length = frames.shape[-1]
    if _use_direct_engine(length, frames.dtype):
        return direct_rfft(frames)
    if _use_matmul_engine(length):
        return matmul_rfft(frames)
    return jnp.fft.rfft(frames, axis=-1)


def fft(frames: jnp.ndarray, n: int | None = None) -> jnp.ndarray:
    """Full complex FFT along the last axis."""
    if n is not None and n != frames.shape[-1]:
        frames = _pad_or_trim(frames, n)
    if _use_matmul_engine(frames.shape[-1]):
        return matmul_fft(frames)
    return jnp.fft.fft(frames, axis=-1)


def ifft(spectra: jnp.ndarray, n: int | None = None) -> jnp.ndarray:
    """Full complex inverse FFT along the last axis."""
    if n is not None and n != spectra.shape[-1]:
        spectra = _pad_or_trim(spectra, n)
    length = spectra.shape[-1]
    if _use_matmul_engine(length):
        return matmul_ifft(spectra)
    return jnp.fft.ifft(spectra, axis=-1)


def _pad_or_trim(x: jnp.ndarray, n: int) -> jnp.ndarray:
    if n <= x.shape[-1]:
        return x[..., :n]
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])])


def full_from_half(half: jnp.ndarray, n: int) -> jnp.ndarray:
    """Reconstruct a length-``n`` full spectrum from ``rfft`` output.

    For real input ``x``, ``FFT(x)[k] = conj(FFT(x)[n-k])``; this appends the
    mirrored conjugate bins so the result matches ``np.fft.fft`` of the real
    signal (the reference's output convention, zaf.py:139) without computing
    them.

    Formulated as an index gather on the real/imag *planes*;
    ``real()``/``imag()`` of an upstream ``lax.complex`` fuse away, so the
    engine path never materializes the half spectrum as complex.
    """
    re, im = jnp.real(half), jnp.imag(half)
    idx = jnp.asarray(_mirror_index(half.shape[-1], n))
    re_f = jnp.concatenate([re, re[..., idx]], axis=-1)
    im_f = jnp.concatenate([im, -im[..., idx]], axis=-1)
    return jax.lax.complex(re_f, im_f)


@lru_cache(maxsize=16)
def _mirror_index(half_len: int, n: int):
    """Gather index for the mirrored interior bins only (the contiguous
    half rides a plain concat): ``full[k] = conj(half[n - k])`` for
    ``k = half_len..n-1``."""
    return (n - np.arange(half_len, n)).astype(np.int32)


@lru_cache(maxsize=16)
def _four_step_factors(n: int):
    """Split ``n = n1*n2`` (powers of two, near-square) and precompute the
    DFT/twiddle matrices on host in float64."""
    if n & (n - 1):
        raise ValueError(f"matmul_fft needs a power-of-two length, got {n}")
    log = n.bit_length() - 1
    n1 = 1 << (log // 2)
    n2 = n // n1
    w1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    w2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    twiddle = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n)
    return n1, n2, w1, w2, twiddle


def matmul_fft(x: jnp.ndarray) -> jnp.ndarray:
    """Full complex FFT along the last axis via the four-step (Bailey)
    algorithm: two matmul stages plus a twiddle multiply.

    O(N·(N1+N2)) FLOPs instead of O(N log N): the FFT expressed as GEMMs.
    Power-of-two lengths only.

    With ``n = n1*n2``, ``n = n1 + N1*n2`` index split and ``k = k2 + N2*k1``:
    ``X[k2+N2*k1] = sum_n1 W1[n1,k1] * Tw[n1,k2] * sum_n2 A[n1,n2] W2[n2,k2]``
    where ``A[n1,n2] = x[n1+N1*n2]``.
    """
    n = x.shape[-1]
    n1, n2, w1, w2, twiddle = _four_step_factors(n)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        cdtype = x.dtype
    else:
        cdtype = (jnp.complex64
                  if jnp.result_type(x, jnp.float32) == jnp.float32
                  else jnp.complex128)
    # Precision: an unqualified f32 matmul may run at reduced precision
    # (TF32 on the GPU) — unacceptable for an FFT engine whose accuracy
    # contract is ~f32. The policy default (HIGHEST) asks for true f32
    # products.
    from zaftpu.core.policy import matmul_precision, real_matmul

    hi = matmul_precision()

    def const_c(m):
        return jnp.asarray(m.astype(cdtype))

    a = jnp.swapaxes(x.reshape(*x.shape[:-1], n2, n1), -1, -2)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        b = jnp.matmul(a.astype(cdtype), const_c(w2),
                       preferred_element_type=cdtype, precision=hi)
    else:
        # Real input: stage 1 as two real matmuls (half the work of a
        # complex x complex product on promoted input).
        rdtype = jnp.float32 if cdtype == jnp.complex64 else jnp.float64
        ar = a.astype(rdtype)
        b = jax.lax.complex(
            real_matmul(ar, jnp.asarray(w2.real.astype(rdtype))),
            real_matmul(ar, jnp.asarray(w2.imag.astype(rdtype))))
    b = b * const_c(twiddle)
    c = jnp.einsum("nk,...nm->...km", const_c(w1), b, precision=hi)
    return c.reshape(*x.shape[:-1], n)


def matmul_rfft(x: jnp.ndarray) -> jnp.ndarray:
    """Real-input spectrum bins ``0..N/2`` via :func:`matmul_fft`.

    Batched real rows are row-packed: adjacent pairs ``(x_even, x_odd)``
    become one complex row ``x_even + i*x_odd``, one complex FFT computes
    both spectra, and conjugate symmetry unpacks them —
    ``X_even[k] = (Z[k] + conj(Z[-k]))/2``,
    ``X_odd[k] = (Z[k] - conj(Z[-k]))/(2i)``. Halves the four-step matmul
    work for the STFT/DCT analysis paths (the frame axis is always the
    second-to-last here).
    """
    n = x.shape[-1]
    if (x.ndim >= 2 and x.shape[-2] >= 2
            and not jnp.issubdtype(x.dtype, jnp.complexfloating)):
        return _packed_rfft(x)
    return matmul_fft(x)[..., : n // 2 + 1]


def _packed_rfft(x: jnp.ndarray) -> jnp.ndarray:
    """Batched rfft over the last axis via pair-packing along axis -2."""
    *lead, b, n = x.shape
    half = n // 2 + 1
    if b % 2:
        x = jnp.pad(x, [(0, 0)] * len(lead) + [(0, 1), (0, 0)])
    z = jax.lax.complex(x[..., 0::2, :], x[..., 1::2, :])
    zf = matmul_fft(z)
    # conj(Z[(n-k) mod n]) for k = 0..n/2 — i.e. bins [0, n-1, ..., n/2].
    zrev = jnp.concatenate([zf[..., :1], zf[..., :0:-1]], axis=-1)
    zh, zc = zf[..., :half], jnp.conj(zrev[..., :half])
    x_even = 0.5 * (zh + zc)
    diff = zh - zc  # = 2i * X_odd, so X_odd = (imag(diff) - i*real(diff))/2
    x_odd = jax.lax.complex(0.5 * jnp.imag(diff), -0.5 * jnp.real(diff))
    out = jnp.stack([x_even, x_odd], axis=-2)  # (..., b/2, 2, half)
    out = out.reshape(*lead, -1, half)
    return out[..., :b, :]


def matmul_ifft(x: jnp.ndarray) -> jnp.ndarray:
    """Inverse FFT via the four-step engine: ``conj(FFT(conj(X)))/N``."""
    n = x.shape[-1]
    return jnp.conj(matmul_fft(jnp.conj(x))) / n


@lru_cache(maxsize=8)
def _direct_rdft_mats(n: int, rdtype_name: str):
    """Host-precomputed ``(N, N/2+1)`` cos/sin DFT matrices (float64 math,
    cast to the target real dtype)."""
    k = np.arange(n // 2 + 1)
    ang = (-2.0 * np.pi / n) * ((np.arange(n)[:, None] * k[None, :]) % n)
    return (np.cos(ang).astype(rdtype_name), np.sin(ang).astype(rdtype_name))


@lru_cache(maxsize=8)
def _direct_ridft_half_mats(n: int, rdtype_name: str, scale: float = 1.0):
    """Host-precomputed ``(N/2+1, N)`` inverse-DFT cos/sin matrices over the
    non-mirrored bins, with the conjugate-pair weights (2 for interior bins,
    1 for DC and — when N is even — Nyquist) and 1/N folded in (float64
    math, cast to the target real dtype). ``scale`` multiplies the operator
    columns — callers fold a COLA gain division into the GEMM here, killing
    the post-OLA elementwise pass (reference semantics zaf.py:241)."""
    half = n // 2 + 1
    k = np.arange(half)
    weights = np.full(half, 2.0)
    weights[0] = 1.0
    if n % 2 == 0:
        weights[-1] = 1.0
    ang = (2.0 * np.pi / n) * ((k[:, None] * np.arange(n)[None, :]) % n)
    row_scale = (weights * (float(scale) / n))[:, None]
    return ((np.cos(ang) * row_scale).astype(rdtype_name),
            (np.sin(ang) * row_scale).astype(rdtype_name))


def direct_rfft(x: jnp.ndarray) -> jnp.ndarray:
    """Real FFT of small frames as two full-width GEMMs.

    ``X = x @ C + i * (x @ S)`` with ``C/S`` the ``(N, N/2+1)`` cos/sin DFT
    matrices: one tall ``(T, N) @ (N, N/2+1)`` GEMM pair with contraction
    dimension N. Exact-path precision comes from the policy dial (HIGHEST
    default; see :func:`zaftpu.core.policy.matmul_precision`).
    """
    from zaftpu.core.policy import real_matmul

    n = x.shape[-1]
    rdtype = jnp.result_type(x, jnp.float32)
    cos_m, sin_m = _direct_rdft_mats(n, np.dtype(rdtype).name)
    xr = x.astype(rdtype)
    return jax.lax.complex(
        real_matmul(xr, jnp.asarray(cos_m)),
        real_matmul(xr, jnp.asarray(sin_m)))


def direct_real_ifft(z: jnp.ndarray, scale: float = 1.0) -> jnp.ndarray:
    """``real(ifft(Z)) * scale`` of small spectra as two half-width GEMMs.

    Valid for *arbitrary* (possibly non-Hermitian) complex input — the same
    semantics as :func:`real_ifft`'s full complex inverse, so masked spectra
    behave identically: since ``real(IFFT(Z))`` is linear in Z and the
    anti-Hermitian part of Z contributes only to ``imag(IFFT(Z))``, it
    equals the inverse-rfft of the Hermitian fold
    ``H_k = (Z_k + conj(Z_{(N-k) mod N})) / 2``, ``k = 0..N/2``. The fold is
    one elementwise pass; the inverse then costs a ``(T, N/2+1) @ (N/2+1,
    N)`` GEMM pair — half the work of the full ``(T, N) @ (N, N)``
    formulation. This is the ISTFT synthesis hot path (reference
    zaf.py:222-233). ``scale`` folds a constant division (the ISTFT's COLA
    gain, zaf.py:241) into the host-precomputed operator columns — exact
    linear algebra, kills the post-OLA elementwise pass; rounding differs
    from a post-division by ≤1 ulp.
    """
    n = z.shape[-1]
    # Hermitian fold H_k = (Z_k + conj(Z_{(N-k) mod N})) / 2, done on the
    # real/imag planes with an index gather. Arithmetic is per-component
    # identical to the complex form (conj negates imag), so the f64 oracle
    # is bit-unchanged.
    h_re, h_im = hermitian_fold_planes(jnp.real(z), jnp.imag(z), n)
    return direct_real_ifft_folded(h_re, h_im, n, scale)


def hermitian_fold_planes(zr: jnp.ndarray, zi: jnp.ndarray, n: int):
    """The Hermitian fold ``H_k = (Z_k + conj(Z_{(N-k) mod N})) / 2`` on
    (re, im) planes over the last axis (:func:`direct_real_ifft`'s fold,
    exposed so split sharded pipelines can run the fold in a separate
    program while staying bit-identical)."""
    half = n // 2 + 1
    idx_rev = jnp.asarray(_fold_index(n))
    return (0.5 * (zr[..., :half] + zr[..., idx_rev]),
            0.5 * (zi[..., :half] - zi[..., idx_rev]))


def direct_real_ifft_folded(h_re: jnp.ndarray, h_im: jnp.ndarray, n: int,
                            scale: float = 1.0) -> jnp.ndarray:
    """The GEMM half of :func:`direct_real_ifft`, taking pre-folded
    Hermitian planes ``(..., N/2+1)`` (bit-identical composition:
    ``direct_real_ifft(z, s) == direct_real_ifft_folded(
    *hermitian_fold_planes(real(z), imag(z), n), n, s)``)."""
    from zaftpu.core.policy import real_matmul

    rdtype = jnp.result_type(h_re, jnp.float32)
    cos_m, sin_m = _direct_ridft_half_mats(n, np.dtype(rdtype).name,
                                           float(scale))
    return (real_matmul(h_re, jnp.asarray(cos_m))
            - real_matmul(h_im, jnp.asarray(sin_m)))


@lru_cache(maxsize=16)
def _fold_index(n: int):
    """Gather index for the Hermitian fold: bin ``(N - k) mod N`` for
    ``k = 0..N/2``."""
    k = np.arange(n // 2 + 1)
    return ((n - k) % n).astype(np.int32)


def real_ifft(spectra: jnp.ndarray) -> jnp.ndarray:
    """``real(ifft(X))`` along the last axis (reference zaf.py:223).

    Kept as a full complex inverse FFT (not ``irfft``) on purpose: the
    reference's ISTFT accepts arbitrary — possibly non-Hermitian, e.g.
    masked — spectra and defines the output as the real part of the complex
    inverse; ``irfft`` would silently assume symmetry and change semantics.
    """
    n = spectra.shape[-1]
    if direct_engine_enabled(n):
        return direct_real_ifft(spectra)
    return jnp.real(ifft(spectra))


def windowed_frames_rfft(padded, window, window_length: int, step: int,
                         number_times: int):
    """Windowed overlapped frames -> rfft half-spectrum ``(..., T, WL//2+1)``
    (the shared STFT/spectrogram/mel analysis front end). XLA fuses the
    framing and the window multiply into the FFT's input."""
    return rfft(_frame.windowed_frames(padded, window, window_length, step,
                                       number_times))


def synthesis_ola(spectra, step: int, gain: float = 1.0):
    """Synthesis back end from *bins-major* spectra ``(..., N, T)``:
    ``overlap_add(real_ifft(spectraᵀ), step) / gain`` (reference
    zaf.py:222-241).

    On the direct-GEMM engine path the COLA gain division folds into the
    host-precomputed inverse operator columns (:func:`direct_real_ifft`
    ``scale``); otherwise real_ifft + OLA + post-division."""
    n = spectra.shape[-2]
    frames_major = jnp.swapaxes(spectra, -1, -2)
    if direct_engine_enabled(n):
        frames = direct_real_ifft(frames_major, scale=1.0 / gain)
        return _frame.overlap_add(frames, step)
    out = _frame.overlap_add(real_ifft(frames_major), step)
    if gain != 1.0:
        out = out / jnp.asarray(gain, dtype=out.dtype)
    return out
