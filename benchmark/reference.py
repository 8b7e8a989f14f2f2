"""The plain reference: Zaf-Python's functions, restated in float64.

Nothing here imports the program or takes anything it made. Windows,
filterbanks and CQT kernels are built on the host in NumPy from the
reference library's published construction; the transforms themselves run
as straightforward JAX programs in float64 (full complex FFTs, gathered
frames, scatter-added overlap-add), block by block so that an hour of audio
fits beside what the program left on the device. Call the device functions
inside ``jax.enable_x64(True)``.

Each comparison returns the largest absolute gap between the program's
output and the reference's, and the largest absolute value of the
reference, so that a caller can state the gap as a share of the peak.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


# --------------------------------------------------------------------------
# Host-side operators (NumPy, float64)
# --------------------------------------------------------------------------

def hamming(length: int, periodic: bool = True) -> np.ndarray:
    """``scipy.signal.windows.hamming(length, sym=not periodic)``."""
    n = np.arange(length, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (length if periodic
                                                   else length - 1))


def hann(length: int, periodic: bool = True) -> np.ndarray:
    """``scipy.signal.windows.hann(length, sym=not periodic)``."""
    n = np.arange(length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length if periodic
                                                 else length - 1))


WINDOWS = {"hamming": hamming, "hann": hann}


def window(spec: dict) -> np.ndarray:
    """The analysis window a configuration's ``stft`` group names."""
    return WINDOWS[spec["window"]](spec["window_length"],
                                   spec.get("periodic", True))


def melfilterbank(sampling_frequency: int, window_length: int,
                  number_mels: int) -> np.ndarray:
    """Zaf's mel filterbank, dense ``(number_mels, window_length // 2)``:
    triangles of constant mel width between one FFT bin and Nyquist, with
    their edges rounded to whole bins before the ramps are laid."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    lo = to_mel(sampling_frequency / window_length)
    hi = to_mel(sampling_frequency / 2)
    width = 2.0 * (hi - lo) / (number_mels + 1)
    edges = np.round(to_hz(np.arange(lo, hi + 1, width / 2.0))
                     * window_length / sampling_frequency).astype(int)
    bank = np.zeros((number_mels, window_length // 2))
    for i in range(number_mels):
        a, b, c = edges[i], edges[i + 1], edges[i + 2]
        bank[i, a - 1:b] = np.linspace(0.0, 1.0, b - a + 1)
        bank[i, b - 1:c] = np.linspace(1.0, 0.0, c - b + 1)
    return bank


def cqtkernel(sampling_frequency: float, octave_resolution: int,
              minimum_frequency: float, maximum_frequency: float):
    """Zaf's constant-Q kernel as a dense ``(F, fft_length)`` complex128
    array: symmetric-Hamming-windowed complex exponentials of odd length,
    centred, FFT'd, entries under 0.01 in magnitude set to zero,
    conjugated and divided by ``fft_length``."""
    q = 1.0 / (2.0 ** (1.0 / octave_resolution) - 1.0)
    count = round(octave_resolution
                  * np.log2(maximum_frequency / minimum_frequency))
    length_fft = int(2.0 ** np.ceil(np.log2(q * sampling_frequency
                                            / minimum_frequency)))
    kernel = np.zeros((count, length_fft), dtype=np.complex128)
    for i in range(count):
        freq = minimum_frequency * 2.0 ** (i / octave_resolution)
        length = 2 * round(q * sampling_frequency / freq / 2) + 1
        offsets = np.arange(-(length - 1) / 2, (length - 1) / 2 + 1)
        atom = (hamming(length, periodic=False)
                * np.exp(2j * np.pi * q * offsets / length) / length)
        start = (length_fft - length + 1) // 2
        kernel[i, start:start + length] = atom
    kernel = np.fft.fft(kernel, axis=1)
    kernel[np.abs(kernel) < 0.01] = 0.0
    return np.conj(kernel) / length_fft


def stft_frames(number_samples: int, window_length: int, step: int) -> int:
    """Zaf's frame count: centring pad of ``window_length // 2`` on both
    sides, one frame per ``step`` that starts inside the padded signal."""
    pad = window_length // 2
    return int(math.ceil((number_samples + 2 * pad - window_length)
                         / step)) + 1


# --------------------------------------------------------------------------
# Device-side transforms (JAX, float64; run under jax.enable_x64(True))
# --------------------------------------------------------------------------

def _blocks(total: int, block: int) -> int:
    return -(-total // block)


@partial(jax.jit, static_argnames=("lead", "count", "spec_first",
                                   "y_first", "step", "block"))
def _stft_istft_range(x, win, gain, spec, y, lead, count, spec_first,
                      y_first, step, block):
    """STFT and ISTFT in float64 over ``count`` consecutive frames.

    ``x`` is the stretch of signal under those frames, ``lead`` zeros of
    centring pad before it; frame ``f`` starts at sample ``f * step`` of
    the padded stretch. The program's ``spec`` ``(WL, S)`` holds frames
    ``spec_first .. spec_first + S - 1``; its ``y`` holds the overlap-added
    stretch from sample ``y_first`` on, divided by ``gain`` (only samples
    that every overlapping frame reaches may be asked for). Returns
    (spectrum gap, spectrum peak, signal gap, signal peak).
    """
    f64, c128 = jnp.float64, jnp.complex128
    wl = win.shape[0]
    nblocks = _blocks(count, block)
    span = (block - 1) * step + wl
    total = nblocks * block * step + wl
    padded = jnp.zeros(total, f64).at[lead:lead + x.shape[0]].set(
        x.astype(f64))
    held = spec.shape[1]
    spec = jnp.pad(spec, ((0, 0), (spec_first,
                                   nblocks * block - spec_first - held)))
    inside = jnp.zeros(nblocks * block, bool).at[
        spec_first:spec_first + held].set(True)
    grid = (jnp.arange(block)[:, None] * step
            + jnp.arange(wl)[None, :])

    def body(b, carry):
        acc, gap, peak = carry
        j0 = b * block
        seg = jax.lax.dynamic_slice(padded, (j0 * step,), (span,))
        ref = jnp.fft.fft(seg[grid] * win, axis=-1)
        ref = jnp.where(((j0 + jnp.arange(block)) < count)[:, None], ref, 0)
        got = jax.lax.dynamic_slice(spec, (0, j0), (wl, block)).T
        mine = jax.lax.dynamic_slice(inside, (j0,), (block,))[:, None]
        gap = jnp.maximum(gap, jnp.max(jnp.where(
            mine, jnp.abs(got.astype(c128) - ref), 0.0)))
        peak = jnp.maximum(peak, jnp.max(jnp.where(mine, jnp.abs(ref), 0.0)))
        frames = jnp.real(jnp.fft.ifft(ref, axis=-1))
        ola = jnp.zeros(span, f64).at[grid.reshape(-1)].add(
            frames.reshape(-1))
        here = jax.lax.dynamic_slice(acc, (j0 * step,), (span,))
        acc = jax.lax.dynamic_update_slice(acc, here + ola, (j0 * step,))
        return acc, gap, peak

    zero = jnp.zeros((), f64)
    acc, gap, peak = jax.lax.fori_loop(
        0, nblocks, body, (jnp.zeros(total, f64), zero, zero))
    ref_y = acc[y_first:y_first + y.shape[0]] / gain
    y_gap = jnp.max(jnp.abs(y.astype(f64) - ref_y))
    return gap, peak, y_gap, jnp.max(jnp.abs(ref_y))


def stft_istft_range_gaps(x, win: np.ndarray, step: int, spec, y, *,
                          lead: int, count: int, spec_first: int,
                          y_first: int, block: int = 2048):
    """:func:`stft_istft_gaps` over a range of frames (see
    :func:`_stft_istft_range`); all arrays on one device."""
    gain = float(win[::step].sum())
    out = _stft_istft_range(x, jnp.asarray(win, jnp.float64),
                            jnp.float64(gain), spec, y, lead, count,
                            spec_first, y_first, step, min(block, count))
    s_gap, s_peak, y_gap, y_peak = (float(v) for v in out)
    return {"spectrum": (s_gap, s_peak), "signal": (y_gap, y_peak)}


def stft_istft_gaps(x, win: np.ndarray, step: int, spec, y,
                    block: int = 2048):
    """``{"spectrum": (gap, peak), "signal": (gap, peak)}`` of the
    program's STFT ``spec`` ``(WL, T)`` of ``x`` and its ISTFT ``y``:
    Zaf's centred frames, full complex FFT, real inverse FFT, overlap-add,
    the trim of ``WL - step`` samples at each end and the division by
    ``sum(window[::step])``."""
    wl, t = win.shape[0], spec.shape[1]
    if y.shape[0] != t * step - wl + step:
        raise ValueError(f"signal of {y.shape[0]} samples does not match "
                         f"{t} frames")
    return stft_istft_range_gaps(x, win, step, spec, y, lead=wl // 2,
                                 count=t, spec_first=0, y_first=wl - step,
                                 block=block)


@partial(jax.jit, static_argnames=("step",))
def _mel_gaps(clip, win, bank, mel, step):
    f64 = jnp.float64
    n, wl = clip.shape[0], win.shape[0]
    t = mel.shape[1]
    pad = wl // 2
    padded = jnp.zeros(t * step + wl, f64).at[pad:pad + n].set(
        clip.astype(f64))
    grid = jnp.arange(t)[:, None] * step + jnp.arange(wl)[None, :]
    spec = jnp.fft.fft(padded[grid] * win, axis=-1)[:, 1:wl // 2 + 1]
    ref = bank @ jnp.abs(spec).T
    return jnp.max(jnp.abs(mel.astype(f64) - ref)), jnp.max(jnp.abs(ref))


def mel_gaps(clip, win: np.ndarray, step: int, bank: np.ndarray, mel):
    """``(gap, peak)`` of the program's mel spectrogram ``mel``
    ``(M, T)`` of one ``clip``: Zaf's magnitude spectrogram over bins
    ``1..WL/2`` times the filterbank."""
    if mel.shape[1] != stft_frames(clip.shape[0], win.shape[0], step):
        raise ValueError(f"mel spectrogram of {mel.shape[1]} frames does "
                         f"not match {clip.shape[0]} samples")
    gap, peak = _mel_gaps(jnp.asarray(clip), jnp.asarray(win, jnp.float64),
                          jnp.asarray(bank, jnp.float64), mel, step)
    return float(gap), float(peak)


@partial(jax.jit, static_argnames=("step", "length_fft",
                                                 "block"))
def _cqt_gaps(x, k_cols, cols, cqt, step, length_fft, block):
    f64 = jnp.float64
    n = x.shape[0]
    t = cqt.shape[1]
    nblocks = _blocks(t, block)
    front = -(-(length_fft - step) // 2)
    span = (block - 1) * step + length_fft
    padded = jnp.zeros(nblocks * block * step + length_fft, f64)
    padded = padded.at[front:front + n].set(x.astype(f64))
    cqt = jnp.pad(cqt, ((0, 0), (0, nblocks * block - t)))
    grid = (jnp.arange(block)[:, None] * step
            + jnp.arange(length_fft)[None, :])
    f = k_cols.shape[0]

    def body(b, carry):
        gap, peak = carry
        j0 = b * block
        seg = jax.lax.dynamic_slice(padded, (j0 * step,), (span,))
        spec = jnp.fft.fft(seg[grid], axis=-1)[:, cols]
        ref = jnp.abs(spec @ k_cols.T)
        valid = ((j0 + jnp.arange(block)) < t)[:, None]
        got = jax.lax.dynamic_slice(cqt, (0, j0), (f, block)).T
        gap = jnp.maximum(gap, jnp.max(jnp.where(
            valid, jnp.abs(got.astype(f64) - ref), 0.0)))
        peak = jnp.maximum(peak, jnp.max(jnp.where(valid, ref, 0.0)))
        return gap, peak

    zero = jnp.zeros((), f64)
    return jax.lax.fori_loop(0, nblocks, body, (zero, zero))


def cqt_gaps(x, kernel: np.ndarray, step: int, cqt, block: int = 256):
    """``(gap, peak)`` of the program's CQT magnitudes ``cqt`` ``(F, T)``
    of ``x``: Zaf's ``|K . fft(frame)|`` for frames ``step`` apart in the
    signal padded by ``ceil((L - step) / 2)`` zeros in front, over the
    kernel's nonzero columns."""
    if cqt.shape[1] != x.shape[0] // step:
        raise ValueError(f"CQT of {cqt.shape[1]} frames does not match "
                         f"{x.shape[0]} samples at step {step}")
    cols = np.nonzero(np.any(kernel != 0, axis=0))[0]
    gap, peak = _cqt_gaps(jnp.asarray(x),
                          jnp.asarray(kernel[:, cols], jnp.complex128),
                          jnp.asarray(cols, jnp.int32), cqt, step,
                          kernel.shape[1], min(block, cqt.shape[1]))
    return float(gap), float(peak)
