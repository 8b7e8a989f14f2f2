"""One request: ``zaftpu.cqtspectrogram`` of a segment, output left on the
device.

Traffic ``input``: as for ``stft_istft``. The deployment builds its kernel
once with ``zaftpu.cqtkernel`` from the configuration's ``cqt`` group.
Compared: the CQT magnitudes against the float64 reference (Zaf's
``|K . fft(frame)|`` with a kernel built here), as the largest gap over the
peak.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark import reference, signals


def _shape(cfg: dict, traffic: dict):
    sr = cfg["sampling_frequency"]
    n = int(traffic["input"]["segment_seconds"] * sr)
    step = round(sr / cfg["cqt"]["time_resolution"])
    return n, step, n // step


def _kernel(cfg: dict) -> np.ndarray:
    c = cfg["cqt"]
    return reference.cqtkernel(cfg["sampling_frequency"],
                               c["octave_resolution"],
                               c["minimum_frequency"],
                               c["maximum_frequency"])


def work(cfg: dict, traffic: dict) -> dict:
    """Bytes: read the signal, write the magnitudes. Operations, of the
    least-work formulation the library implements: a real FFT of each
    frame (2.5 L log2 L), the kernel's nonzero complex weights (eight per
    weight) and a magnitude per bin."""
    n, step, t = _shape(cfg, traffic)
    kernel = _kernel(cfg)
    bins, length = kernel.shape
    nnz = int(np.count_nonzero(kernel))
    return {"bytes": 4 * n + 4 * bins * t,
            "flops": t * (2.5 * length * math.log2(length) + 8 * nnz
                          + 3 * bins)}


class Entry:
    def __init__(self, cfg: dict, traffic: dict, seed: int, devices):
        import zaftpu

        self._zaftpu = zaftpu
        n, self.step, _ = _shape(cfg, traffic)
        sr = cfg["sampling_frequency"]
        c = cfg["cqt"]
        self._sr, self._rate = sr, c["time_resolution"]
        self._kernel = zaftpu.cqtkernel(sr, c["octave_resolution"],
                                        c["minimum_frequency"],
                                        c["maximum_frequency"])
        mix = signals.ToneMix.from_seed(seed, sr)
        self.inputs = signals.device_pieces(
            mix, traffic["input"]["segments"], n)
        self.audio_s = n / sr
        self._cfg = cfg

    def submit(self, i: int):
        return self._zaftpu.cqtspectrogram(
            self.inputs[i % len(self.inputs)], self._sr, self._rate,
            self._kernel)

    def check(self, kept: dict) -> dict:
        kernel = _kernel(self._cfg)
        worst = 0.0
        for i, cqt in kept.items():
            gap, peak = reference.cqt_gaps(self.inputs[i % len(self.inputs)],
                                           kernel, self.step, cqt)
            worst = max(worst, gap / peak)
        return {"cqt_err": worst}
