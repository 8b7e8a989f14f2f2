"""One request: ``zaftpu.stft`` of a segment, then ``zaftpu.istft`` of that
spectrum. Both outputs stay on the device.

Traffic ``input``: ``segments`` pieces of ``segment_seconds`` each, made on
the device from the seed; request ``i`` takes segment ``i % segments``.
Compared: the full complex spectrum and the reconstruction, each against
the float64 reference chain, as the largest gap over the reference's peak.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark import reference, signals


def _shape(cfg: dict, traffic: dict):
    sr = cfg["sampling_frequency"]
    n = int(traffic["input"]["segment_seconds"] * sr)
    st = cfg["stft"]
    wl, step = st["window_length"], st["step_length"]
    return n, wl, step, reference.stft_frames(n, wl, step)


def work(cfg: dict, traffic: dict) -> dict:
    """Bytes and operations one request cannot avoid, from its shapes.

    Bytes: read the signal, write the full complex64 spectrum, read it
    back, write the signal. Operations: a real FFT of each windowed frame
    (2.5 N log2 N), and for the inverse the Hermitian fold and a real
    inverse FFT (2.5 N log2 N), plus the window, fold and overlap-add (one
    operation per sample of each frame apiece).
    """
    n, wl, step, t = _shape(cfg, traffic)
    out = t * step - wl + step
    fft = 2.5 * wl * math.log2(wl)
    return {"bytes": 4 * n + 2 * 8 * wl * t + 4 * out,
            "flops": t * (2 * fft + 3 * wl)}


class Entry:
    def __init__(self, cfg: dict, traffic: dict, seed: int, devices):
        import zaftpu

        self._zaftpu = zaftpu
        n, wl, self.step, _ = _shape(cfg, traffic)
        sr = cfg["sampling_frequency"]
        self.window = reference.window(cfg["stft"])
        self._window32 = self.window.astype(np.float32)
        count = traffic["input"]["segments"]
        mix = signals.ToneMix.from_seed(seed, sr)
        self.inputs = signals.device_pieces(mix, count, n)
        self.audio_s = n / sr

    def submit(self, i: int):
        z = self._zaftpu
        spec = z.stft(self.inputs[i % len(self.inputs)], self._window32,
                      self.step)
        return spec, z.istft(spec, self._window32, self.step)

    def check(self, kept: dict) -> dict:
        worst = {"spectrum_err": 0.0, "signal_err": 0.0}
        for i, (spec, y) in kept.items():
            gaps = reference.stft_istft_gaps(
                self.inputs[i % len(self.inputs)], self.window, self.step,
                spec, y)
            for key, (gap, peak) in (("spectrum_err", gaps["spectrum"]),
                                     ("signal_err", gaps["signal"])):
                worst[key] = max(worst[key], gap / peak)
        return worst
