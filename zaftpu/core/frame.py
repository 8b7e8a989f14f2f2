"""Framing, padding, and overlap-add primitives — the geometric heart of every
transform in the framework.

The reference frames with O(T) Python loops (zaf.py:131-136 analysis,
zaf.py:227-233 synthesis OLA, zaf.py:1173-1179 TDAC). Here both directions are
closed-form tensor programs with static shapes so XLA can fuse and tile them:

* **analysis** (``extract_frames``): when ``step`` divides ``window_length``
  the overlapped frame matrix is assembled from K = WL/step *contiguous
  slice-reshapes* of the padded signal — zero gathers, pure layout ops that
  XLA folds into the consumer. A gather fallback covers general hops.
* **synthesis** (``overlap_add``): the loop-carried overlap-add becomes a sum
  of K statically-shifted block views — the only true sequential dependency in
  the reference (adjacent frames writing overlapping ranges, zaf.py:227-233)
  turns into K-1 elementwise adds. A scatter-add fallback covers general hops.

All padding arithmetic reproduces the reference's formulas exactly
(zaf.py:99-125 for STFT, zaf.py:1036-1041 for MDCT).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def stft_padding(number_samples: int, window_length: int, step_length: int):
    """Centering pad lengths and frame count for STFT analysis.

    Reproduces reference zaf.py:99-125: pad ``floor(WL/2)`` zeros at the
    start; ``T = ceil(((N + 2*pad) - WL)/step) + 1``; end-pad so the padded
    length is exactly ``T*step + (WL - step)``.

    Returns ``(pad_front, pad_back, number_times)``.
    """
    pad_front = window_length // 2
    number_times = (
        int(np.ceil(((number_samples + 2 * pad_front) - window_length)
                    / step_length)) + 1
    )
    padded_length = number_times * step_length + (window_length - step_length)
    pad_back = padded_length - number_samples - pad_front
    return pad_front, pad_back, number_times


def extract_frames(padded: jnp.ndarray, window_length: int, step_length: int,
                   number_times: int) -> jnp.ndarray:
    """Slice an overlapped frame matrix out of a padded signal.

    ``padded`` has shape ``(..., L)`` with
    ``L >= number_times*step + (window_length - step)``; returns
    ``(..., number_times, window_length)`` where frame ``j`` starts at sample
    ``j*step`` (reference zaf.py:131-136 loop semantics).
    """
    wl, s, t = window_length, step_length, number_times
    needed = t * s + (wl - s)
    padded = padded[..., :needed]
    if wl % s == 0:
        # K contiguous block views, no gather: blocks (..., T+K-1, s);
        # frame j = concat(blocks[j], ..., blocks[j+K-1]).
        k = wl // s
        blocks = padded.reshape(padded.shape[:-1] + (t + k - 1, s))
        parts = [blocks[..., i:i + t, :] for i in range(k)]
        return jnp.concatenate(parts, axis=-1)
    # General hop: one gather with a static index grid.
    starts = np.arange(t) * s
    idx = starts[:, None] + np.arange(wl)[None, :]
    return padded[..., idx]


def windowed_frames(padded: jnp.ndarray, window: jnp.ndarray,
                    window_length: int, step_length: int,
                    number_times: int) -> jnp.ndarray:
    """:func:`extract_frames` times the analysis window (one fused pass)."""
    frames = extract_frames(padded, window_length, step_length, number_times)
    return frames * window.astype(frames.dtype)


def overlap_add(frames: jnp.ndarray, step_length: int) -> jnp.ndarray:
    """Constant overlap-add of ``(..., T, WL)`` frames at hop ``step``.

    Output shape ``(..., T*step + WL - step)`` — the reference's sequential
    COLA loop (zaf.py:227-233) / TDAC loop (zaf.py:1173-1179) as a sum of K
    shifted block views when ``step | WL``, else a scatter-add.
    """
    *lead, t, wl = frames.shape
    s = step_length
    out_len = t * s + (wl - s)
    if wl % s == 0:
        k = wl // s
        # chunk c of frame j lands at block j+c of the length-s block grid:
        # sum K top/bottom-padded chunk planes. The pads fuse as masked
        # operand reads, so XLA emits ONE write pass over the output — a
        # zeros + .at[].add formulation compiles to K read-modify-write
        # passes (measured 0.67 vs 0.30 ms on the CPU). Per-element addition
        # order is c ascending, left-associated.
        lead_pad = [(0, 0)] * len(lead)
        chunks = frames.reshape(*lead, t, k, s)
        total = jnp.pad(chunks[..., :, 0, :],
                        lead_pad + [(0, k - 1), (0, 0)])
        for c in range(1, k):
            total = total + jnp.pad(chunks[..., :, c, :],
                                    lead_pad + [(c, k - 1 - c), (0, 0)])
        return total.reshape(*lead, out_len)
    starts = np.arange(t) * s
    idx = (starts[:, None] + np.arange(wl)[None, :]).reshape(-1)
    flat = frames.reshape(*lead, t * wl)
    out = jnp.zeros((*lead, out_len), dtype=frames.dtype)
    return out.at[..., idx].add(flat)


def cola_gain(window: np.ndarray, step_length: int) -> float:
    """COLA normalization gain ``sum(window[::step])`` (reference zaf.py:241)."""
    return float(np.asarray(window, dtype=np.float64)[::step_length].sum())
