"""One request: ``zaftpu.melspectrogram`` of one clip held on the host, as
a service receives it, including its copy to the device; the request ends
when the ``(mels, frames)`` output is ready on the device.

Traffic ``input``: a pool of ``clips`` distinct clips of ``clip_seconds``
each, made from the seed; request ``i`` takes clip ``i % clips``.
Compared: every kept output against the float64 reference (magnitude
spectrogram times Zaf's filterbank), as the largest gap over the peak.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark import reference, signals


def _shape(cfg: dict, traffic: dict):
    sr = cfg["sampling_frequency"]
    n = int(traffic["input"]["clip_seconds"] * sr)
    st = cfg["stft"]
    wl, step = st["window_length"], st["step_length"]
    return n, wl, step, reference.stft_frames(n, wl, step)


def work(cfg: dict, traffic: dict) -> dict:
    """Bytes: read the clip on the device, write the mel spectrogram.
    Operations: window and real FFT of each frame, the magnitude of each
    kept bin, and the filterbank's nonzero weights (two per weight)."""
    n, wl, step, t = _shape(cfg, traffic)
    mels = cfg["mel"]["number_mels"]
    nnz = int(np.count_nonzero(reference.melfilterbank(
        cfg["sampling_frequency"], wl, mels)))
    return {"bytes": 4 * n + 4 * mels * t,
            "flops": t * (2.5 * wl * math.log2(wl) + wl + 3 * (wl // 2)
                          + 2 * nnz)}


class Entry:
    def __init__(self, cfg: dict, traffic: dict, seed: int, devices):
        import zaftpu

        self._zaftpu = zaftpu
        n, wl, self.step, _ = _shape(cfg, traffic)
        sr = cfg["sampling_frequency"]
        self.window = reference.window(cfg["stft"])
        self._window32 = self.window.astype(np.float32)
        self.bank = reference.melfilterbank(sr, wl, cfg["mel"]["number_mels"])
        # The deployment's filterbank comes from the library's own builder.
        self._bank = zaftpu.melfilterbank(sr, wl, cfg["mel"]["number_mels"])
        mix = signals.ToneMix.from_seed(seed, sr)
        self.inputs = signals.host_clips(mix, traffic["input"]["clips"], n)
        self.audio_s = n / sr

    def submit(self, i: int):
        return self._zaftpu.melspectrogram(
            self.inputs[i % len(self.inputs)], self._window32, self.step,
            self._bank)

    def check(self, kept: dict) -> dict:
        worst = 0.0
        for i, mel in kept.items():
            gap, peak = reference.mel_gaps(self.inputs[i % len(self.inputs)],
                                           self.window, self.step,
                                           self.bank, mel)
            worst = max(worst, gap / peak)
        return {"mel_err": worst}
