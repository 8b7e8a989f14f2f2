"""Frozen configuration dataclasses with the reference's documented defaults.

The reference has no config system — conventions live in docstrings
(zaf.py:67-77 window length = 2^ceil(log2(0.04*sr)), half-overlap step;
zaf.py:585-591 CQT defaults octave_resolution=24, fmin=55, fmax=3520,
time_resolution=25). These dataclasses make those conventions explicit and
hashable so they can key jit caches and precomputed-operator caches.

Two kinds of config live here:

* **Parameter configs** (:class:`StftConfig`, :class:`MelConfig`,
  :class:`CqtConfig`, :class:`MdctConfig`) — user-facing bundles of the
  reference's positional arguments, accepted by the public transforms via
  the ``config=`` keyword (``zaftpu.stft(x, config=StftConfig(...))``).
* **:class:`DispatchConfig`** — the snapshot of every ``ZAFTPU_*`` dispatch
  flag consulted while *tracing* a transform. The jit wrapper
  (:func:`zaftpu.core.dispatch.zjit`) keys its trace caches on the current
  snapshot, so flipping a flag between two same-shape calls retraces with
  the new dispatch instead of silently reusing a stale program.
"""

from __future__ import annotations

import dataclasses
import math
import os


def default_window_length(sampling_frequency: int | float,
                          window_duration: float = 0.04) -> int:
    """Power-of-two window length covering ``window_duration`` seconds.

    Mirrors the docstring convention at reference zaf.py:67-71
    (``2^ceil(log2(0.04*sr))``, 2048 at 44.1 kHz).
    """
    return 2 ** int(math.ceil(math.log2(window_duration * sampling_frequency)))


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """STFT analysis parameters (reference zaf.py:45-141 conventions)."""

    window_length: int = 2048
    step_length: int = 1024
    window: str = "hamming"  # periodic (sym=False) for COLA, zaf.py:73-74

    @classmethod
    def for_rate(cls, sampling_frequency: int, overlap: int = 2) -> "StftConfig":
        wl = default_window_length(sampling_frequency)
        return cls(window_length=wl, step_length=wl // overlap)

    def window_array(self):
        """The configured window as a float64 host array."""
        from zaftpu.core.windows import get_window

        return get_window(self.window, self.window_length)


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Mel filterbank / MFCC parameters (reference zaf.py:353,410-414)."""

    sampling_frequency: int = 44100
    window_length: int = 2048
    number_mels: int = 40
    number_coefficients: int = 20
    step_length: int = 1024      # half overlap, reference zaf.py:75-77
    window: str = "hamming"      # periodic, reference zaf.py:73-74

    def window_array(self):
        """The configured analysis window as a float64 host array."""
        from zaftpu.core.windows import get_window

        return get_window(self.window, self.window_length)

    def filterbank(self):
        """The configured mel filterbank (cached)."""
        from zaftpu.features.mel import melfilterbank

        return melfilterbank(self.sampling_frequency, self.window_length,
                             self.number_mels)


@dataclasses.dataclass(frozen=True)
class CqtConfig:
    """CQT parameters (reference docstring defaults zaf.py:585-591)."""

    sampling_frequency: int = 44100
    octave_resolution: int = 24
    minimum_frequency: float = 55.0
    maximum_frequency: float = 3520.0
    time_resolution: int = 25

    def kernel(self):
        """The configured CQT kernel (memory- and disk-cached)."""
        from zaftpu.transforms.cqt import cqtkernel

        return cqtkernel(self.sampling_frequency, self.octave_resolution,
                         self.minimum_frequency, self.maximum_frequency)


@dataclasses.dataclass(frozen=True)
class MdctConfig:
    """MDCT parameters — 50% overlap is structural (reference zaf.py:1029)."""

    window_length: int = 2048
    window: str = "vorbis"  # sine-slope window, zaf.py:1100

    def window_array(self):
        """The configured window as a float64 host array."""
        from zaftpu.core.windows import get_window

        return get_window(self.window, self.window_length)


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Hashable snapshot of every trace-time ``ZAFTPU_*`` dispatch flag.

    Library programs consult these flags *while tracing* (engine selection in
    ``core/fft.py``, precision/dtype policy in ``core/policy.py``, the
    sharded program structure). jit caches therefore must be keyed on the
    snapshot — otherwise flipping a flag after a shape has been seen silently
    reuses the stale trace (a user A/B-ing engines in one notebook process
    would get right numbers under wrong labels). :func:`current` is read
    fresh on every public-transform call by
    :func:`zaftpu.core.dispatch.zjit`.

    ``matmul_dtype`` is the *resolved* operator-matmul dtype — the
    :func:`zaftpu.core.policy.compute_dtype` context override folded together
    with ``ZAFTPU_DTYPE`` — so entering/leaving the bf16 context retraces
    too.
    """

    fft: str = "auto"
    fft_direct_max: int = 4096
    sharded_fuse: str = ""
    precision: str = "highest"
    matmul_dtype: str = ""

    @classmethod
    def current(cls) -> "DispatchConfig":
        """Snapshot the environment + policy context right now."""
        from zaftpu.core import policy as _policy

        try:
            direct_max = int(os.environ.get("ZAFTPU_FFT_DIRECT_MAX", "4096"))
        except ValueError:
            direct_max = 4096
        return cls(
            fft=os.environ.get("ZAFTPU_FFT", "auto"),
            fft_direct_max=direct_max,
            sharded_fuse=os.environ.get("ZAFTPU_SHARDED_FUSE", ""),
            precision=os.environ.get("ZAFTPU_PRECISION", "highest").lower(),
            matmul_dtype=("bfloat16"
                          if _policy.matmul_dtype() is not None else ""),
        )
