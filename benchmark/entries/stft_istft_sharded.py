"""One request: ``zaftpu.sharding.stft_sharded`` of one long signal, then
``istft_sharded`` of that spectrum, over a 1-D mesh of all the cell's
devices. Both outputs stay on the devices.

Traffic ``input``: one signal of ``seconds``, made on the devices from the
seed in equal contiguous pieces, one per device (the layout
``zaftpu.sharding.shard_along`` gives).
Compared: every device's share of the spectrum and of the reconstruction
against the float64 reference chain, computed on that device from the
stretch of signal under its frames, which is copied there from the
devices that hold it. The halo between devices is therefore checked by a
path of its own.
"""

from __future__ import annotations

import numpy as np

from benchmark import reference, signals
from benchmark.entries import stft_istft

AXIS = "frames"


def _shape(cfg: dict, traffic: dict):
    sr = cfg["sampling_frequency"]
    n = int(traffic["input"]["seconds"] * sr)
    st = cfg["stft"]
    wl, step = st["window_length"], st["step_length"]
    return n, wl, step, reference.stft_frames(n, wl, step)


def work(cfg: dict, traffic: dict) -> dict:
    """As for ``stft_istft``, over the whole signal."""
    seconds = traffic["input"]["seconds"]
    return stft_istft.work(cfg, {"input": {"segment_seconds": seconds}})


def _span(index, length: int):
    sl = index[-1]
    return (sl.start or 0), (length if sl.stop is None else sl.stop)


def _stretch(x, lo: int, hi: int, device):
    """Samples ``[lo, hi)`` of the sharded ``x``, gathered onto
    ``device``."""
    import jax
    import jax.numpy as jnp

    parts = []
    for shard in sorted(x.addressable_shards,
                        key=lambda s: _span(s.index, x.shape[0])[0]):
        a, b = _span(shard.index, x.shape[0])
        if b <= lo or a >= hi:
            continue
        parts.append(jax.device_put(
            shard.data[max(lo, a) - a:min(hi, b) - a], device))
        lo = min(hi, b)
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


class Entry:
    def __init__(self, cfg: dict, traffic: dict, seed: int, devices):
        from zaftpu import sharding

        self._sharding = sharding
        self.mesh = sharding.make_mesh(len(devices), axis_name=AXIS,
                                       devices=list(devices))
        self.n, self.wl, self.step, self.frames = _shape(cfg, traffic)
        sr = cfg["sampling_frequency"]
        self.window = reference.window(cfg["stft"])
        self._window32 = self.window.astype(np.float32)
        mix = signals.ToneMix.from_seed(seed, sr)
        self.inputs = [signals.sharded_signal(mix, self.mesh, AXIS, self.n)]
        self.audio_s = self.n / sr

    def submit(self, i: int):
        s = self._sharding
        spec = s.stft_sharded(self.inputs[0], self._window32, self.step,
                              self.mesh, AXIS)
        return spec, s.istft_sharded(spec, self._window32, self.step,
                                     self.mesh, AXIS)

    def check(self, kept: dict) -> dict:
        worst = {"spectrum_err": 0.0, "signal_err": 0.0}
        for spec, y in kept.values():
            gaps = self._gaps(spec, y)
            for key, part in (("spectrum_err", "spectrum"),
                              ("signal_err", "signal")):
                gap = max(g[part][0] for g in gaps)
                peak = max(g[part][1] for g in gaps)
                worst[key] = max(worst[key], gap / peak)
        return worst

    def _gaps(self, spec, y):
        """Per device: the reference over the frames that its spectrum
        columns and its reconstruction samples need."""
        wl, step, t, n = self.wl, self.step, self.frames, self.n
        pad, edge = wl // 2, wl - step
        ys = {s.device: s for s in y.addressable_shards}
        out = []
        for shard in spec.addressable_shards:
            a, b = _span(shard.index, t)
            y_shard = ys[shard.device]
            c, e = _span(y_shard.index, y.shape[0])
            # Frames that reach samples c..e-1 of the trimmed signal.
            first = max(0, -(-(c + edge - wl + 1) // step))
            last = min(t - 1, (e + edge - 1) // step)
            j_lo, j_hi = min(a, first), max(b - 1, last)
            lo, hi = j_lo * step - pad, j_hi * step - pad + wl
            x = _stretch(self.inputs[0], max(0, lo), min(n, hi),
                         shard.device)
            out.append(reference.stft_istft_range_gaps(
                x, self.window, step, shard.data, y_shard.data,
                lead=max(0, -lo), count=j_hi - j_lo + 1,
                spec_first=a - j_lo, y_first=c + edge - j_lo * step))
        return out
