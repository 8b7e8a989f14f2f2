"""Chip smoke test: every transform family on the GPU, through the public API.

Run from the repository root::

    python chip_smoke.py          # one GPU: phases 1-7
    python chip_smoke.py --four   # four GPUs: the frame-sharded path only

Signals are generated from a seed. Each check prints one line: the phase,
its name, the warm time, the compared quantity beside its limit, and the
card's name and power limit as nvidia-smi reports them. A failed check
raises, so the script exits non-zero; nothing is caught and passed over.
The last line of a passing run is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

With no GPU the script exits non-zero and prints no result. JAX's default
matmul precision is left unset, as users leave it, so an f32 matmul that
silently ran in TF32 shows up in the parity phase.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SR, WL, STEP = 44100, 2048, 1024
PARITY_SECONDS = 23          # the reference fixture's length
HOUR_SECONDS = 3600
FAMILY_SECONDS = 600         # one hour-scale segment
STREAM_SECONDS = 600
FORWARD_SNR_DB = 90.0        # f32 forward transforms vs the f64 oracle
ROUND_TRIP_SNR_DB = 96.0     # the 16-bit floor bench.py enforces
LOGMEL_ATOL = 5e-3           # tests/test_mel.py f32 gate
CHROMA_ATOL = 5e-4           # tests/test_cqt.py f32 gate
BF16_CQT_SNR_DB = 45.0       # tests/test_bf16.py bf16 gate
SAME_PROGRAM_SNR_DB = 110.0  # sharded or streamed vs plain: f32 rounding only


class CheckFailed(AssertionError):
    """A smoke check missed its limit."""


class Report:
    """Prints one line per check with the card beside it; raises on a miss."""

    def __init__(self, card: str):
        self.card = card

    def check(self, phase, name, seconds, quantity, value, limit,
              at_most=False):
        value = float(value)
        ok = value <= limit if at_most else value >= limit  # NaN fails
        op = "<=" if at_most else ">="
        print(f"[{phase}] {name}: warm {seconds:.6f} s, {quantity} "
              f"{value:.6g} {op} {limit:g} {'ok' if ok else 'FAILED'} "
              f"[{self.card}]", flush=True)
        if not ok:
            raise CheckFailed(f"{phase} {name}: {quantity} {value!r} "
                              f"not {op} {limit!r}")

    def info(self, phase, text):
        print(f"[{phase}] {text} [{self.card}]", flush=True)


def warm(fn, *args):
    """Compile with one call, then time one call to ``block_until_ready``;
    returns ``(seconds, output)``."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def snr_db(ref, est) -> float:
    """``10 log10(sum|ref|^2 / sum|ref - est|^2)`` in float64 on the host,
    over the common prefix of the last axis."""
    from zaftpu.bench.harness import snr_db as _db

    ref, est = np.asarray(ref), np.asarray(est)
    n = min(ref.shape[-1], est.shape[-1])
    ref = ref[..., :n].astype(np.complex128 if np.iscomplexobj(ref)
                              else np.float64)
    return _db(float(np.sum(np.abs(ref) ** 2)),
               float(np.sum(np.abs(est[..., :n] - ref) ** 2)))


def device_snr_db(ref, est) -> float:
    """:func:`snr_db` reduced on the device (hour-scale outputs stay
    there), with float32 sums."""
    from zaftpu.bench.harness import snr_db as _db, snr_parts

    return _db(*snr_parts(ref, est))


def oracle(fn, *args):
    """``fn`` on the CPU backend in float64: the parity oracle (the same
    public function the tests hold to the reference's goldens)."""
    import jax

    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        args = [np.asarray(a, np.complex128 if np.iscomplexobj(a)
                           else np.float64) for a in args]
        return np.asarray(fn(*args))


def _setup():
    import zaftpu
    from zaftpu.core.windows import hamming, vorbis

    return {
        "hamming": hamming(WL),
        "vorbis": vorbis(WL),
        "fbank": zaftpu.melfilterbank(SR, WL, 40),
        "kernel": zaftpu.cqtkernel(SR, 24, 55, 3520),
    }


def _families(ops):
    """(name, fn(signal, window)) for every forward family, at Zaf's
    documented settings (BASELINE.json)."""
    import zaftpu

    fbank, kern, tdac = ops["fbank"], ops["kernel"], ops["vorbis"]
    return [
        ("stft", lambda x, w: zaftpu.stft(x, w, STEP)),
        ("spectrogram", lambda x, w: zaftpu.spectrogram(x, w, STEP)),
        ("cqtspectrogram", lambda x, w: zaftpu.cqtspectrogram(x, SR, 25,
                                                              kern)),
        ("mdct", lambda x, w: zaftpu.mdct(x, tdac.astype(x.dtype))),
        ("melspectrogram", lambda x, w: zaftpu.melspectrogram(x, w, STEP,
                                                              fbank)),
        ("mfcc", lambda x, w: zaftpu.mfcc(x, w, STEP, fbank, 20)),
        ("cqtchromagram", lambda x, w: zaftpu.cqtchromagram(x, SR, 25, 24,
                                                            kern)),
    ]


def phase_parity(report, seconds=PARITY_SECONDS, rows=64):
    """Every family in float32 on the default device against the f64
    oracle on the CPU."""
    import zaftpu
    from zaftpu.bench.harness import seeded_signal
    from zaftpu.features.mel import _LOG_EPS

    ops = _setup()
    x = seeded_signal(seconds, seed=23)
    w64 = ops["hamming"]
    w32 = w64.astype(np.float32)
    for name, fn in _families(ops):
        sec, got = warm(fn, x, w32)
        ref = oracle(fn, x, w64)
        if name in ("melspectrogram", "mfcc"):
            if name == "melspectrogram":
                got, ref = np.log(np.asarray(got) + _LOG_EPS), np.log(
                    ref + _LOG_EPS)
            err = float(np.max(np.abs(np.asarray(got) - ref)))
            report.check("parity", name, sec, "max abs err"
                         + (" (log-mel)" if name == "melspectrogram" else ""),
                         err, LOGMEL_ATOL, at_most=True)
        elif name == "cqtchromagram":
            err = float(np.max(np.abs(np.asarray(got) - ref)))
            report.check("parity", name, sec, "max abs err", err,
                         CHROMA_ATOL, at_most=True)
        else:
            report.check("parity", name, sec, "SNR dB vs f64",
                         snr_db(ref, got), FORWARD_SNR_DB)
    spec64 = oracle(lambda x, w: zaftpu.stft(x, w, STEP), x, w64)
    sec, got = warm(lambda s: zaftpu.istft(s, w32, STEP),
                    spec64.astype(np.complex64))
    ref = oracle(lambda s, w: zaftpu.istft(s, w, STEP), spec64, w64)
    report.check("parity", "istft", sec, "SNR dB vs f64", snr_db(ref, got),
                 FORWARD_SNR_DB)
    tdac = ops["vorbis"]
    coeffs64 = oracle(zaftpu.mdct, x, tdac)
    sec, got = warm(lambda c: zaftpu.imdct(c, tdac.astype(np.float32)),
                    coeffs64.astype(np.float32))
    ref = oracle(zaftpu.imdct, coeffs64, tdac)
    report.check("parity", "imdct", sec, "SNR dB vs f64", snr_db(ref, got),
                 FORWARD_SNR_DB)
    block = x[:rows * 1024].reshape(rows, 1024)
    for kind in ("dct", "dst"):
        for ttype in (1, 2, 3, 4):
            fn = getattr(zaftpu, kind)
            sec, got = warm(lambda b: fn(b, ttype), block)
            ref = oracle(lambda b: fn(b, ttype), block)
            report.check("parity", f"{kind}{ttype}", sec, "SNR dB vs f64",
                         snr_db(ref, got), FORWARD_SNR_DB)
    mag64 = np.abs(spec64[:WL // 2 + 1])
    sec, got = warm(lambda m: zaftpu.griffin_lim(m, w32, STEP, 8),
                    mag64.astype(np.float32))
    ref = oracle(lambda m, w: zaftpu.griffin_lim(m, w, STEP, 8), mag64, w64)
    report.check("parity", "griffin_lim (8 iterations)", sec,
                 "SNR dB vs f64", snr_db(ref, got), FORWARD_SNR_DB)


def phase_hour(report, seconds=HOUR_SECONDS):
    """STFT->ISTFT and MDCT->IMDCT over the seeded hour in 600-s segments;
    the round trips must clear the 16-bit floor."""
    import jax.numpy as jnp

    import zaftpu
    from zaftpu.bench.harness import round_trip_snr_db, segments
    from zaftpu.core.frame import stft_padding

    ops = _setup()
    w32 = ops["hamming"].astype(np.float32)
    tdac = ops["vorbis"].astype(np.float32)
    signals = [jnp.asarray(x) for x in segments(seconds)]
    lens = [int(x.shape[0]) for x in signals]
    t_stft = sum(stft_padding(n, WL, STEP)[2] for n in lens)
    t_mdct = sum(int(np.ceil(n / STEP)) + 1 for n in lens)

    def pass_of(fn, inputs):
        return warm(lambda xs: [fn(v) for v in xs], inputs)

    s_fwd, specs = pass_of(lambda v: zaftpu.stft(v, w32, STEP), signals)
    s_inv, recs = pass_of(lambda s: zaftpu.istft(s, w32, STEP), specs)
    del specs
    snr = round_trip_snr_db(signals, recs)
    del recs
    report.info("hour", f"stft {s_fwd:.6f} s/pass = {t_stft / s_fwd:.1f} "
                        f"frames/s; istft {s_inv:.6f} s/pass = "
                        f"{t_stft / s_inv:.1f} frames/s "
                        f"({len(signals)} segments, {t_stft} frames)")
    report.check("hour", "stft->istft", s_fwd + s_inv, "round-trip SNR dB",
                 snr, ROUND_TRIP_SNR_DB)
    s_fwd, coeffs = pass_of(lambda v: zaftpu.mdct(v, tdac), signals)
    s_inv, recs = pass_of(lambda c: zaftpu.imdct(c, tdac), coeffs)
    del coeffs
    snr = round_trip_snr_db(signals, recs)
    report.info("hour", f"mdct {s_fwd:.6f} s/pass = {t_mdct / s_fwd:.1f} "
                        f"frames/s; imdct {s_inv:.6f} s/pass = "
                        f"{t_mdct / s_inv:.1f} frames/s")
    report.check("hour", "mdct->imdct", s_fwd + s_inv, "round-trip SNR dB",
                 snr, ROUND_TRIP_SNR_DB)


def phase_families(report, seconds=FAMILY_SECONDS, rows=1024):
    """Every family at a 600-s segment, warm, once each; prints the STFT
    program's compiled memory analysis."""
    import jax.numpy as jnp

    import zaftpu
    from zaftpu.bench.harness import seeded_signal
    from zaftpu.config import DispatchConfig
    from zaftpu.transforms.stft import _stft_full

    ops = _setup()
    w32 = ops["hamming"].astype(np.float32)
    tdac = ops["vorbis"].astype(np.float32)
    x = jnp.asarray(seeded_signal(seconds, seed=600))

    def finite(name, sec, out):
        report.check("family", f"{name} {tuple(out.shape)}", sec,
                     "all finite", bool(jnp.all(jnp.isfinite(out))), 1.0)

    for name, fn in _families(ops):
        finite(name, *warm(fn, x, w32))
    spec = zaftpu.stft(x, w32, STEP)
    finite("istft", *warm(lambda s: zaftpu.istft(s, w32, STEP), spec))
    mag = jnp.abs(spec[:WL // 2 + 1])
    del spec
    finite("griffin_lim (8 iterations)",
           *warm(lambda m: zaftpu.griffin_lim(m, w32, STEP, 8), mag))
    del mag
    coeffs = zaftpu.mdct(x, tdac)
    finite("imdct", *warm(lambda c: zaftpu.imdct(c, tdac), coeffs))
    del coeffs
    block = x[:rows * 1024].reshape(rows, 1024)
    for kind in ("dct", "dst"):
        for ttype in (1, 2, 3, 4):
            fn = getattr(zaftpu, kind)
            finite(f"{kind}{ttype}", *warm(lambda b: fn(b, ttype), block))
    compiled = _stft_full._zjit.lower(
        x, jnp.asarray(w32), step_length=STEP,
        _dispatch=DispatchConfig.current()).compile()
    report.info("family", f"stft memory_analysis: "
                          f"{compiled.memory_analysis()}")


def phase_dials(report, seconds=PARITY_SECONDS):
    """The dials users can reach: split4 precision, the bf16 compute dtype
    and the matmul-FFT engine, each against the same oracle."""
    import zaftpu
    from zaftpu.bench.harness import seeded_signal

    ops = _setup()
    x = seeded_signal(seconds, seed=23)
    w64, tdac64 = ops["hamming"], ops["vorbis"]
    w32, tdac32 = w64.astype(np.float32), tdac64.astype(np.float32)
    stft_ref = oracle(lambda v, w: zaftpu.stft(v, w, STEP), x, w64)
    mdct_ref = oracle(zaftpu.mdct, x, tdac64)

    def round_trips(label):
        sec, spec = warm(lambda v: zaftpu.stft(v, w32, STEP), x)
        report.check("dials", f"{label} stft", sec, "SNR dB vs f64",
                     snr_db(stft_ref, spec), FORWARD_SNR_DB)
        sec, rec = warm(lambda s: zaftpu.istft(s, w32, STEP), spec)
        report.check("dials", f"{label} stft->istft", sec,
                     "round-trip SNR dB", snr_db(x, rec), ROUND_TRIP_SNR_DB)
        sec, coeffs = warm(lambda v: zaftpu.mdct(v, tdac32), x)
        report.check("dials", f"{label} mdct", sec, "SNR dB vs f64",
                     snr_db(mdct_ref, coeffs), FORWARD_SNR_DB)
        sec, rec = warm(lambda c: zaftpu.imdct(c, tdac32), coeffs)
        report.check("dials", f"{label} mdct->imdct", sec,
                     "round-trip SNR dB", snr_db(x, rec), ROUND_TRIP_SNR_DB)

    for env in ({"ZAFTPU_PRECISION": "split4"},
                {"ZAFTPU_FFT": "matmul"},
                {"ZAFTPU_PRECISION": "split4", "ZAFTPU_FFT": "matmul"}):
        label = "+".join(f"{k}={v}" for k, v in env.items())
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            round_trips(label)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    kern, fbank = ops["kernel"], ops["fbank"]
    cqt32 = np.asarray(zaftpu.cqtspectrogram(x, SR, 25, kern))
    mel32 = np.asarray(zaftpu.melspectrogram(x, w32, STEP, fbank))
    mfcc32 = np.asarray(zaftpu.mfcc(x, w32, STEP, fbank, 20))
    with zaftpu.compute_dtype("bfloat16"):
        sec, cqt16 = warm(lambda v: zaftpu.cqtspectrogram(v, SR, 25, kern),
                          x)
        mel16 = np.asarray(zaftpu.melspectrogram(x, w32, STEP, fbank))
        mfcc16 = np.asarray(zaftpu.mfcc(x, w32, STEP, fbank, 20))
    report.check("dials", "bf16 cqtspectrogram", sec, "SNR dB vs f32",
                 snr_db(cqt32, cqt16), BF16_CQT_SNR_DB)
    report.check("dials", "bf16 melspectrogram (exempt)", 0.0,
                 "max abs diff vs f32", np.max(np.abs(mel16 - mel32)), 0.0,
                 at_most=True)
    report.check("dials", "bf16 mfcc (exempt)", 0.0, "max abs diff vs f32",
                 np.max(np.abs(mfcc16 - mfcc32)), 0.0, at_most=True)


def _sharded_pairs(ops, mesh):
    """(name, sharded fn(x), plain fn(x)) for the six sharded transforms;
    the synthesis pairs take the plain forward output."""
    import zaftpu
    from zaftpu import sharding

    w32 = ops["hamming"].astype(np.float32)
    tdac = ops["vorbis"].astype(np.float32)
    fbank, kern = ops["fbank"], ops["kernel"]
    return [
        ("stft_sharded", lambda x: sharding.stft_sharded(x, w32, STEP, mesh),
         lambda x: zaftpu.stft(x, w32, STEP), None),
        ("istft_sharded",
         lambda s: sharding.istft_sharded(s, w32, STEP, mesh),
         lambda s: zaftpu.istft(s, w32, STEP),
         lambda x: zaftpu.stft(x, w32, STEP)),
        ("mfcc_sharded",
         lambda x: sharding.mfcc_sharded(x, w32, STEP, fbank, 20, mesh),
         lambda x: zaftpu.mfcc(x, w32, STEP, fbank, 20), None),
        ("mdct_sharded", lambda x: sharding.mdct_sharded(x, tdac, mesh),
         lambda x: zaftpu.mdct(x, tdac), None),
        ("imdct_sharded", lambda c: sharding.imdct_sharded(c, tdac, mesh),
         lambda c: zaftpu.imdct(c, tdac), lambda x: zaftpu.mdct(x, tdac)),
        ("cqtspectrogram_sharded",
         lambda x: sharding.cqtspectrogram_sharded(x, SR, 25, kern, mesh),
         lambda x: zaftpu.cqtspectrogram(x, SR, 25, kern), None),
    ]


def phase_sharded_one(report, seconds=FAMILY_SECONDS, devices=None):
    """The six sharded transforms on a 1-device mesh over a 600-s segment,
    each against the plain transform."""
    import jax
    import jax.numpy as jnp

    from zaftpu.bench.harness import seeded_signal
    from zaftpu.sharding import make_mesh

    mesh = make_mesh(1, devices=devices or jax.devices())
    x = jnp.asarray(seeded_signal(seconds, seed=601))
    for name, sharded, plain, prep in _sharded_pairs(_setup(), mesh):
        arg = x if prep is None else prep(x)
        ref = jax.block_until_ready(plain(arg))
        sec, got = warm(sharded, arg)
        diff = float(jnp.max(jnp.abs(got - ref)))
        report.check("sharded-1", f"{name} (max abs diff {diff:.3g})", sec,
                     "SNR dB vs plain", device_snr_db(ref, got),
                     SAME_PROGRAM_SNR_DB)


def phase_stream(report, seconds=STREAM_SECONDS, workdir=None):
    """A seeded WAV written with the native codec, streamed through
    BlockReader -> STFT, against the in-memory STFT."""
    import jax.numpy as jnp

    import zaftpu
    from zaftpu.bench.harness import seeded_signal
    from zaftpu.core import fft as _fft
    from zaftpu.core.dispatch import zjit
    from zaftpu.core.frame import stft_padding
    from zaftpu.io import native
    from zaftpu.io.pipeline import StreamingTransform

    if native.load() is None:
        raise CheckFailed("native WAV codec did not build")
    workdir = workdir or os.path.join(REPO, ".smoke")
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "stream.wav")
    try:
        x = seeded_signal(seconds, seed=602)
        native.write_f32(path, SR, x)
        w32 = _setup()["hamming"].astype(np.float32)
        window = jnp.asarray(w32)
        pad_front, _, t = stft_padding(len(x), WL, STEP)

        @zjit
        def block_fn(samples):
            b = (samples.shape[0] - (WL - STEP)) // STEP
            return _fft.windowed_frames_rfft(samples, window, WL, STEP, b)

        stream = StreamingTransform(path, WL, STEP, pad_front, t, block_fn)
        if stream.reader._native is None:
            raise CheckFailed("BlockReader did not open the native codec")
        t0 = time.perf_counter()
        got = stream.run().T
        sec = time.perf_counter() - t0
        ref = np.asarray(zaftpu.stft(jnp.asarray(x), w32, STEP))
        report.check("stream", f"BlockReader->stft {got.shape}", sec,
                     "SNR dB vs in-memory stft",
                     snr_db(ref[:WL // 2 + 1], got), SAME_PROGRAM_SNR_DB)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _replicated(x, mesh):
    """``x`` placed whole on every device of ``mesh`` (a committed array on
    one device cannot enter a program over other devices)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.block_until_ready(
        jax.device_put(x, NamedSharding(mesh, PartitionSpec())))


def phase_four(report, seconds=HOUR_SECONDS, batch_seconds=FAMILY_SECONDS,
               devices=None):
    """The frame-sharded path on four devices: the six sharded transforms
    over the seeded hour on a 4-device mesh, and stft/istft/cqt on a 2x2
    batch x frames mesh, each against the single-device result on device
    0; outputs must span all four devices."""
    import jax
    import jax.numpy as jnp

    from zaftpu.bench.harness import segments
    from zaftpu.sharding import make_mesh, make_mesh_2d

    devices = devices or jax.devices()
    if len(devices) < 4:
        raise CheckFailed(f"--four needs 4 devices, have {len(devices)}")
    ops = _setup()
    x = jax.device_put(np.concatenate(list(segments(seconds, seed=4))),
                       devices[0])
    mesh1 = make_mesh(1, devices=devices)
    mesh4 = make_mesh(4, devices=devices)
    one = {name: fn for name, fn, _, _ in _sharded_pairs(ops, mesh1)}
    for name, sharded, plain, prep in _sharded_pairs(ops, mesh4):
        arg = x if prep is None else jax.block_until_ready(prep(x))
        ref = jax.block_until_ready(plain(arg))
        sec1, _ = warm(one[name], arg)
        sec4, got = warm(sharded, _replicated(arg, mesh4))
        spans = len(got.sharding.device_set)
        report.info("four", f"{name}: 1 card {sec1:.6f} s, 4 cards "
                            f"{sec4:.6f} s ({sec1 / sec4:.3f}x)")
        report.check("four", f"{name} spans", sec4, "devices", spans, 4)
        report.check("four", name, sec4, "SNR dB vs 1 card",
                     device_snr_db(ref, got), SAME_PROGRAM_SNR_DB)
        del ref, got, arg
    batch = jax.device_put(np.stack([
        next(segments(batch_seconds, seed=5)),
        next(segments(batch_seconds, seed=6))]), devices[0])
    mesh22 = make_mesh_2d(2, 2, devices=devices)
    pairs = {name: (fn, plain, prep)
             for name, fn, plain, prep in _sharded_pairs(ops, mesh22)}
    for name in ("stft_sharded", "istft_sharded", "cqtspectrogram_sharded"):
        fn, plain, prep = pairs[name]
        arg = batch if prep is None else prep(batch)
        sec, got = warm(fn, _replicated(arg, mesh22))
        spans = len(got.sharding.device_set)
        report.check("four-2x2", f"{name} spans", sec, "devices", spans, 4)
        ref = jnp.stack([plain(arg[i]) for i in range(2)])
        report.check("four-2x2", name, sec, "SNR dB vs 1 card",
                     device_snr_db(ref, got), SAME_PROGRAM_SNR_DB)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-GPU frame-sharded phase")
    args = parser.parse_args(argv)

    from zaftpu.bench import device as _device

    devices = _device.require_gpu()
    card = _device.card_info()
    _device.enable_compile_cache(REPO)
    record = _device.device_record(devices)
    report = Report(card)
    print(f"[device] {record['kind']} x{record['count']} "
          f"({record['platform']}); nvidia-smi: {card}", flush=True)
    if args.four:
        phase_four(report, devices=devices)
    else:
        phase_parity(report)
        phase_hour(report)
        phase_families(report)
        phase_dials(report)
        phase_sharded_one(report, devices=devices)
        phase_stream(report)
    print(json.dumps({"ok": True, "device": record}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
