"""Orthonormal DCT and DST, types I-IV, via zero-embedded real FFTs.

Same math as the reference (zaf.py:703-981): each transform is an embedding of
the input into a longer sequence whose FFT contains the transform in its real
(DCT) or negated imaginary (DST) part, followed by the orthonormalizing
scalings. Differences from the reference:

* batched over arbitrary leading axes (the reference is strictly 1-D), so a
  whole block of segments runs as one fused device program;
* the embeddings are real, so a single ``rfft`` replaces the full complex FFT
  (half the work; every output bin the transforms read lies in the
  non-negative-frequency half) — routed through :mod:`zaftpu.core.fft`, so
  ``ZAFTPU_FFT=matmul`` applies (the type-IV 8N embedding reaches 32768
  points at N=4096);
* no in-place endpoint mutation — pre/post scalings are expressed as masked
  multiplies that XLA fuses into the surrounding ops.

Inverse pairs (reference docstring zaf.py:872-876): I<->I, II<->III, IV<->IV.
Parity vs ``scipy.fftpack.dct/dst(norm="ortho")`` is gated in
tests/test_dct.py at float64 oracle tolerance.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from zaftpu.core.dispatch import zjit
from zaftpu.core import fft as _fft

_SQRT2 = np.sqrt(2.0)


@lru_cache(maxsize=32)
def _direct_matrix(kind: str, transform_type: int, n: int) -> np.ndarray:
    """The orthonormal DCT/DST as one ``(N, N)`` matrix (float64 host math).

    Under the matmul engine the zero-embedded-FFT formulation is
    wasteful: the type II/III 4N embedding costs ~16x and the type IV 8N
    embedding ~64x the FLOPs of applying the transform matrix directly
    (``x @ M``). Closed forms of the same orthonormal transforms the
    reference computes via FFTs (zaf.py:758-839 / 900-981); parity vs the
    FFT path and scipy is gated in tests/test_dct.py. Types III are the
    transposes of types II (orthogonal inverse pairs, zaf.py:872-876).
    """
    j = np.arange(n, dtype=np.float64)[:, None]  # input sample index
    k = np.arange(n, dtype=np.float64)[None, :]  # output coefficient index
    if kind == "dct":
        if transform_type == 1:
            s = np.ones(n)
            s[0] = s[-1] = 1.0 / _SQRT2
            return (np.sqrt(2.0 / (n - 1)) * (s[:, None] * s[None, :])
                    * np.cos(np.pi * j * k / (n - 1)))
        if transform_type == 2:
            c = np.ones(n)
            c[0] = 1.0 / _SQRT2
            return (np.sqrt(2.0 / n) * c[None, :]
                    * np.cos(np.pi * (2 * j + 1) * k / (2 * n)))
        if transform_type == 3:
            return np.ascontiguousarray(_direct_matrix("dct", 2, n).T)
        return (np.sqrt(2.0 / n)
                * np.cos(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * n)))
    if transform_type == 1:
        return (np.sqrt(2.0 / (n + 1))
                * np.sin(np.pi * (j + 1) * (k + 1) / (n + 1)))
    if transform_type == 2:
        d = np.ones(n)
        d[-1] = 1.0 / _SQRT2
        return (np.sqrt(2.0 / n) * d[None, :]
                * np.sin(np.pi * (2 * j + 1) * (k + 1) / (2 * n)))
    if transform_type == 3:
        return np.ascontiguousarray(_direct_matrix("dst", 2, n).T)
    return (np.sqrt(2.0 / n)
            * np.sin(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * n)))


@partial(zjit, static_argnames=("kind", "transform_type"))
def _apply_direct(x: jnp.ndarray, kind: str,
                  transform_type: int) -> jnp.ndarray:
    from zaftpu.core.policy import real_matmul

    # Trace-time constant (not a runtime argument): XLA owns the operator
    # layout and folds it into the GEMM.
    rdtype = np.float32 if x.dtype == jnp.float32 else np.float64
    matrix = jnp.asarray(
        _direct_matrix(kind, transform_type, x.shape[-1]).astype(rdtype))
    return real_matmul(x, matrix.astype(x.dtype))


def _direct_or_none(kind: str, transform_type: int, x: jnp.ndarray):
    """Apply the folded ``(N, N)`` operator when the direct engine covers
    this length (type-1 transforms need n >= 2 for their denominators,
    which ``direct_engine_enabled`` already guarantees)."""
    if not _fft.direct_engine_enabled(x.shape[-1]):
        return None
    return _apply_direct(x, kind, transform_type)


def _rescale(y, factor: float):
    """Multiply by a host scalar without promoting the array dtype."""
    return y * jnp.asarray(factor, dtype=y.dtype)


def _scale_index(x: jnp.ndarray, index: int, factor: float) -> jnp.ndarray:
    """Multiply element ``index`` of the last axis by ``factor``."""
    return x.at[..., index].multiply(jnp.asarray(factor, dtype=x.dtype))


def _embed(x: jnp.ndarray, length: int, placements) -> jnp.ndarray:
    """Zero array of last-dim ``length`` with ``(slice, values)`` placements."""
    out = jnp.zeros(x.shape[:-1] + (length,), dtype=x.dtype)
    for sl, vals in placements:
        out = out.at[(Ellipsis, sl)].set(vals)
    return out


@partial(zjit, static_argnames=("dct_type",))
def _dct_core(x: jnp.ndarray, dct_type: int) -> jnp.ndarray:
    n = x.shape[-1]
    rev = x[..., ::-1]
    if dct_type == 1:
        # Symmetric 2N-2 extension; endpoint sqrt(2) pre/post scaling makes
        # the matrix orthogonal (reference zaf.py:759-778).
        xe = _scale_index(_scale_index(x, 0, _SQRT2), n - 1, _SQRT2)
        emb = jnp.concatenate([xe, xe[..., -2:0:-1]], axis=-1)
        y = jnp.real(_fft.rfft(emb))[..., :n] / 2.0
        y = _scale_index(_scale_index(y, 0, 1.0 / _SQRT2), n - 1, 1.0 / _SQRT2)
        return _rescale(y, np.sqrt(2.0 / (n - 1)))
    if dct_type == 2:
        # Odd-indexed 4N embedding (reference zaf.py:780-796).
        emb = _embed(x, 4 * n, [(slice(1, 2 * n, 2), x),
                                (slice(2 * n + 1, 4 * n, 2), rev)])
        y = jnp.real(_fft.rfft(emb))[..., :n] / 2.0
        y = _scale_index(y, 0, 1.0 / _SQRT2)
        return _rescale(y, np.sqrt(2.0 / n))
    if dct_type == 3:
        # 4N embedding with sign-flipped reversals (reference zaf.py:798-820).
        xe = _scale_index(x, 0, _SQRT2)
        reve = xe[..., ::-1]
        emb = _embed(xe, 4 * n, [(slice(0, n), xe),
                                 (slice(n + 1, 2 * n + 1), -reve),
                                 (slice(2 * n + 1, 3 * n), -xe[..., 1:]),
                                 (slice(3 * n + 1, 4 * n), reve[..., :-1])])
        y = jnp.real(_fft.rfft(emb))[..., 1:2 * n:2] / 4.0
        return _rescale(y, np.sqrt(2.0 / n))
    if dct_type == 4:
        # Odd-indexed alternating-sign 8N embedding (reference zaf.py:822-839).
        emb = _embed(x, 8 * n, [(slice(1, 2 * n, 2), x),
                                (slice(2 * n + 1, 4 * n, 2), -rev),
                                (slice(4 * n + 1, 6 * n, 2), -x),
                                (slice(6 * n + 1, 8 * n, 2), rev)])
        y = jnp.real(_fft.rfft(emb))[..., 1:2 * n:2] / 4.0
        return _rescale(y, np.sqrt(2.0 / n))
    raise ValueError(f"dct_type must be 1..4, got {dct_type}")


@partial(zjit, static_argnames=("dst_type",))
def _dst_core(x: jnp.ndarray, dst_type: int) -> jnp.ndarray:
    n = x.shape[-1]
    rev = x[..., ::-1]
    if dst_type == 1:
        # Antisymmetric 2N+2 extension (reference zaf.py:901-916).
        emb = _embed(x, 2 * n + 2, [(slice(1, n + 1), x),
                                    (slice(n + 2, 2 * n + 2), -rev)])
        y = -jnp.imag(_fft.rfft(emb))[..., 1:n + 1] / 2.0
        return _rescale(y, np.sqrt(2.0 / (n + 1)))
    if dst_type == 2:
        # Odd-indexed 4N embedding (reference zaf.py:918-934).
        emb = _embed(x, 4 * n, [(slice(1, 2 * n, 2), x),
                                (slice(2 * n + 1, 4 * n, 2), -rev)])
        y = -jnp.imag(_fft.rfft(emb))[..., 1:n + 1] / 2.0
        y = _scale_index(y, n - 1, 1.0 / _SQRT2)
        return _rescale(y, np.sqrt(2.0 / n))
    if dst_type == 3:
        # 4N embedding (reference zaf.py:936-958).
        xe = _scale_index(x, n - 1, _SQRT2)
        reve = xe[..., ::-1]
        emb = _embed(xe, 4 * n, [(slice(1, n + 1), xe),
                                 (slice(n + 1, 2 * n), reve[..., 1:]),
                                 (slice(2 * n + 1, 3 * n + 1), -xe),
                                 (slice(3 * n + 1, 4 * n), -reve[..., 1:])])
        y = -jnp.imag(_fft.rfft(emb))[..., 1:2 * n:2] / 4.0
        return _rescale(y, np.sqrt(2.0 / n))
    if dst_type == 4:
        # Odd-indexed 8N embedding (reference zaf.py:960-981).
        emb = _embed(x, 8 * n, [(slice(1, 2 * n, 2), x),
                                (slice(2 * n + 1, 4 * n, 2), rev),
                                (slice(4 * n + 1, 6 * n, 2), -x),
                                (slice(6 * n + 1, 8 * n, 2), -rev)])
        y = -jnp.imag(_fft.rfft(emb))[..., 1:2 * n:2] / 4.0
        return _rescale(y, np.sqrt(2.0 / n))
    raise ValueError(f"dst_type must be 1..4, got {dst_type}")


def dct(audio_signal, dct_type: int):
    """Orthonormal DCT of type 1-4 along the last axis.

    Matches ``scipy.fftpack.dct(x, type, norm="ortho")`` and reference
    zaf.py:703-839; accepts batched ``(..., N)`` input.
    """
    from zaftpu.core import validate as _validate

    x = _validate.check_signal(jnp.asarray(audio_signal))
    if int(dct_type) not in (1, 2, 3, 4):
        raise ValueError(f"dct_type must be 1..4, got {dct_type}")
    direct = _direct_or_none("dct", int(dct_type), x)
    if direct is not None:
        return direct
    return _dct_core(x, int(dct_type))


def dst(audio_signal, dst_type: int):
    """Orthonormal DST of type 1-4 along the last axis.

    Matches ``scipy.fftpack.dst(x, type, norm="ortho")`` and reference
    zaf.py:842-981; accepts batched ``(..., N)`` input.
    """
    from zaftpu.core import validate as _validate

    x = _validate.check_signal(jnp.asarray(audio_signal))
    if int(dst_type) not in (1, 2, 3, 4):
        raise ValueError(f"dst_type must be 1..4, got {dst_type}")
    direct = _direct_or_none("dst", int(dst_type), x)
    if direct is not None:
        return direct
    return _dst_core(x, int(dst_type))
