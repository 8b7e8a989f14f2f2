"""Benchmark harness: per-transform throughput and mesh-scaling runs.

``python -m zaftpu.bench.harness [--seconds S] [--scaling]`` measures every
transform's frames/s on the current backend, and (with ``--scaling``) the
frame-sharded STFT/ISTFT across mesh sizes. Signals are generated from a
seed (:func:`seeded_signal`). Timings are host-clock seconds around calls
that end in ``block_until_ready``; every row names the backend it ran on.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SR = 44100
#: Hour-scale audio is processed as segments of this many seconds: bench.py,
#: the chip smoke test and this harness all cut long signals this way.
SEGMENT_SECONDS = 600


def seeded_signal(seconds: float, sr: int = SR, seed: int = 0) -> np.ndarray:
    """A deterministic float32 test signal: four tones with slow vibrato
    plus white noise 30 dB down, generated from ``seed`` (audio that reaches
    a device is made, never read from outside the repository)."""
    n = int(round(seconds * sr))
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / sr
    out = 0.03 * rng.standard_normal(n)
    for amp, f0 in zip((0.3, 0.2, 0.15, 0.1),
                       rng.uniform(80.0, 4000.0, size=4)):
        vibrato = 0.002 * f0 * np.sin(2 * np.pi * 5.0 * t)
        out += amp * np.sin(2 * np.pi * f0 * t + vibrato
                            + rng.uniform(0, 2 * np.pi))
    return out.astype(np.float32)


def segments(seconds: float, seed: int = 0):
    """Yield the ``seconds``-long seeded signal as ``SEGMENT_SECONDS``
    pieces (each generated from its own derived seed, so a full hour is
    never held on the host at once)."""
    done, index = 0.0, 0
    while done < seconds:
        piece = min(SEGMENT_SECONDS, seconds - done)
        yield seeded_signal(piece, seed=seed * 1000 + index)
        done += piece
        index += 1


def snr_parts(ref, est):
    """``(sum |ref|^2, sum |ref - est|^2)`` over the common prefix of the
    last axis, reduced in float32 on ``ref``'s devices (``est`` moves
    there first) — hour-scale outputs never come back to the host."""
    import jax
    import jax.numpy as jnp

    n = min(ref.shape[-1], est.shape[-1])
    est = jax.device_put(est, ref.sharding)

    @jax.jit
    def parts(a, b):
        a, b = a[..., :n], b[..., :n]
        return jnp.sum(jnp.abs(a) ** 2), jnp.sum(jnp.abs(a - b) ** 2)

    return tuple(float(v) for v in jax.device_get(parts(ref, est)))


def snr_db(num: float, den: float) -> float:
    """``10 log10(num / den)``; infinite for an exact match (``den == 0``)
    and NaN-propagating, so a ``>=`` gate on it fails on NaN."""
    return float("inf") if den == 0.0 else float(10.0 * np.log10(num / den))


def round_trip_snr_db(signals, reconstructions) -> float:
    """Round-trip SNR over all segments: total signal power over total
    error power (common prefix of each pair)."""
    num = den = 0.0
    for x, rec in zip(signals, reconstructions):
        s, e = snr_parts(x, rec)
        num, den = num + s, den + e
    return snr_db(num, den)


def run_transform_suite(seconds: float = 60.0, reps: int = 3):
    """Time every transform; returns list of dicts (printed as a table)."""
    import jax.numpy as jnp

    import zaftpu
    from zaftpu.core.windows import hamming, vorbis
    from zaftpu.utils.profiling import timed

    wl, step = 2048, 1024
    signals = [jnp.asarray(x) for x in segments(seconds)]
    window = hamming(wl).astype(np.float32)
    tdac = vorbis(wl).astype(np.float32)
    fbank = zaftpu.melfilterbank(SR, wl, 40)
    kernel = zaftpu.cqtkernel(SR, 24, 55, 3520)
    lens = [int(x.shape[0]) for x in signals]
    t_stft = sum(int(np.ceil((n + 2 * (wl // 2) - wl) / step)) + 1
                 for n in lens)
    t_mdct = sum(int(np.ceil(n / step)) + 1 for n in lens)
    t_cqt = sum(n // round(SR / 25) for n in lens)

    rows = []

    def bench(name, fn, frames, inputs):
        # One timed call = one pass over all segments, synchronized once.
        _, stats = timed(name, lambda xs: [fn(x) for x in xs], inputs,
                         frames=frames, reps=reps, log=False)
        rows.append({"transform": name, "seconds": stats.seconds,
                     "frames_per_sec": stats.frames_per_second})

    specs = [zaftpu.stft(x, window, step) for x in signals]
    bench("stft", lambda x: zaftpu.stft(x, window, step), t_stft, signals)
    bench("istft", lambda s: zaftpu.istft(s, window, step), t_stft, specs)
    del specs
    bench("spectrogram", lambda x: zaftpu.spectrogram(x, window, step),
          t_stft, signals)
    bench("melspectrogram",
          lambda x: zaftpu.melspectrogram(x, window, step, fbank), t_stft,
          signals)
    bench("mfcc", lambda x: zaftpu.mfcc(x, window, step, fbank, 20), t_stft,
          signals)
    coeffs = [zaftpu.mdct(x, tdac) for x in signals]
    bench("mdct", lambda x: zaftpu.mdct(x, tdac), t_mdct, signals)
    bench("imdct", lambda c: zaftpu.imdct(c, tdac), t_mdct, coeffs)
    del coeffs
    bench("cqtspectrogram",
          lambda x: zaftpu.cqtspectrogram(x, SR, 25, kernel), t_cqt,
          signals)
    bench("cqtchromagram",
          lambda x: zaftpu.cqtchromagram(x, SR, 25, 24, kernel), t_cqt,
          signals)
    batch = jnp.asarray(seeded_signal(1024 * 1024 / SR, seed=1)
                        .reshape(1024, 1024))
    bench("dct2_batch1024", lambda b: zaftpu.dct(b, 2), 1024, [batch])
    bench("dst2_batch1024", lambda b: zaftpu.dst(b, 2), 1024, [batch])
    return rows


def run_scaling(seconds: float = 60.0, reps: int = 3):
    """Frame-sharded STFT+ISTFT frames/s across mesh sizes."""
    import jax
    import jax.numpy as jnp

    from zaftpu.core.windows import hamming
    from zaftpu.sharding import istft_sharded, make_mesh, stft_sharded
    from zaftpu.utils.profiling import timed

    wl, step = 2048, 1024
    signal = jnp.asarray(seeded_signal(seconds))
    window = hamming(wl).astype(np.float32)
    n = int(signal.shape[0])
    t_stft = int(np.ceil((n + 2 * (wl // 2) - wl) / step)) + 1

    n_dev = len(jax.devices())
    sizes = sorted({1, 2, n_dev} & set(range(1, n_dev + 1)))
    rows = []
    for size in sizes:
        mesh = make_mesh(size)

        def pipeline(x):
            spec = stft_sharded(x, window, step, mesh)
            return istft_sharded(spec, window, step, mesh)

        _, stats = timed(f"stft+istft@{size}", pipeline, signal,
                         frames=t_stft, reps=reps, log=False)
        rows.append({"devices": size, "seconds": stats.seconds,
                     "frames_per_sec": stats.frames_per_second})
    base = rows[0]["frames_per_sec"]
    for row in rows:
        row["scaling_efficiency"] = row["frames_per_sec"] / (
            base * row["devices"])
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seconds", type=float, default=60.0)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--scaling", action="store_true")
    args = parser.parse_args(argv)

    import jax

    device = jax.devices()[0]
    print(f"# backend: {device.platform} ({device.device_kind}), devices: "
          f"{len(jax.devices())}", file=sys.stderr)
    rows = (run_scaling(args.seconds, args.reps) if args.scaling
            else run_transform_suite(args.seconds, args.reps))
    for row in rows:
        row["platform"] = device.platform
        print(json.dumps(row))


if __name__ == "__main__":
    main()
