"""The reference's 12 examples, recreated against the zaftpu API.

Each function mirrors one example section of the reference's docstrings /
examples.ipynb (reference zaf.py example blocks; README.md sections) and
saves its figure as PNG. Run all: ``python examples/examples.py [outdir]``.

Audio fixture: ``/root/reference/audio_file.wav`` when present, else a
deterministic synthetic stand-in.
"""

from __future__ import annotations

import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

import zaftpu  # noqa: E402
from zaftpu.core.windows import hamming, kbd, vorbis  # noqa: E402

FIXTURE = os.environ.get("ZAFTPU_FIXTURE", "/root/reference/audio_file.wav")


def load_audio():
    """Stereo signal + rate: the reference fixture or a synthetic fallback."""
    if os.path.exists(FIXTURE):
        return zaftpu.wavread(FIXTURE)
    sr = 44100
    t = np.arange(8 * sr) / sr
    left = 0.5 * np.sin(2 * np.pi * (220 + 110 * t) * t)
    right = 0.4 * np.sin(2 * np.pi * 330 * t)
    return np.stack([left, right], axis=1), sr


def _analysis_params(sr):
    wl = 2 ** int(np.ceil(np.log2(0.04 * sr)))
    return wl, hamming(wl, periodic=True), wl // 2


def example_stft(outdir):
    """Compute and display the spectrogram of an audio file."""
    audio, sr = load_audio()
    mono = audio.mean(axis=1)
    wl, window, step = _analysis_params(sr)
    spec = np.abs(np.asarray(zaftpu.stft(mono, window, step)))[1:wl // 2 + 1]
    plt.figure(figsize=(14, 7))
    zaftpu.specshow(spec, len(mono), sr, xtick_step=1, ytick_step=1000)
    plt.title("Spectrogram (dB)")
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, "stft.png"))
    plt.close()
    return {"spec": spec}


def example_istft(outdir):
    """Estimate the center and sides from a stereo file (masked ISTFT)."""
    audio, sr = load_audio()
    wl, window, step = _analysis_params(sr)
    stft1 = np.asarray(zaftpu.stft(audio[:, 0], window, step))
    stft2 = np.asarray(zaftpu.stft(audio[:, 1], window, step))
    nf = wl // 2 + 1
    mag1, mag2 = np.abs(stft1[:nf]), np.abs(stft2[:nf])
    mask1 = np.minimum(mag1, mag2) / np.maximum(mag1, 1e-30)
    mask2 = np.minimum(mag1, mag2) / np.maximum(mag2, 1e-30)
    center1 = np.concatenate((mask1, mask1[-2:0:-1])) * stft1
    center2 = np.concatenate((mask2, mask2[-2:0:-1])) * stft2
    sig1 = np.asarray(zaftpu.istft(center1, window, step))
    sig2 = np.asarray(zaftpu.istft(center2, window, step))
    center = np.stack([sig1, sig2], axis=1)[:len(audio)]
    sides = audio[:len(center)] - center
    zaftpu.wavwrite(center, sr, os.path.join(outdir, "center_file.wav"))
    zaftpu.wavwrite(sides, sr, os.path.join(outdir, "sides_file.wav"))
    plt.figure(figsize=(14, 7))
    for i, (sig, title) in enumerate([(audio, "Original signal"),
                                      (center, "Center signal"),
                                      (sides, "Sides signal")]):
        plt.subplot(3, 1, i + 1)
        zaftpu.sigplot(sig, sr, xtick_step=1)
        plt.ylim(-1, 1)
        plt.title(title)
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, "istft.png"))
    plt.close()
    return {"center": center, "sides": sides}


def example_melfilterbank(outdir):
    """Compute and display the mel filterbank."""
    fbank = zaftpu.melfilterbank(44100, 2048, 128)
    plt.figure(figsize=(14, 5))
    plt.imshow(fbank, aspect="auto", cmap="jet", origin="lower")
    plt.title("Mel filterbank")
    plt.xlabel("Frequency index")
    plt.ylabel("Mel index")
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, "melfilterbank.png"))
    plt.close()
    return {"fbank": np.asarray(fbank)}


def example_melspectrogram(outdir):
    """Compute and display the mel spectrogram."""
    audio, sr = load_audio()
    mono = audio.mean(axis=1)
    wl, window, step = _analysis_params(sr)
    fbank = zaftpu.melfilterbank(sr, wl, 128)
    melspec = np.asarray(zaftpu.melspectrogram(mono, window, step, fbank))
    plt.figure(figsize=(14, 5))
    zaftpu.melspecshow(melspec, len(mono), sr, wl, xtick_step=1)
    plt.title("Mel spectrogram (dB)")
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, "melspectrogram.png"))
    plt.close()
    return {"melspec": melspec}


def example_mfcc(outdir):
    """Compute and display MFCCs, delta MFCCs, and delta-delta MFCCs."""
    audio, sr = load_audio()
    mono = audio.mean(axis=1)
    wl, window, step = _analysis_params(sr)
    fbank = zaftpu.melfilterbank(sr, wl, 40)
    mfccs = np.asarray(zaftpu.mfcc(mono, window, step, fbank, 20))
    dmfccs = np.diff(mfccs, n=1, axis=1)
    ddmfccs = np.diff(dmfccs, n=1, axis=1)
    plt.figure(figsize=(14, 7))
    for i, (m, title) in enumerate([(mfccs, "MFCCs"),
                                    (dmfccs, "Delta MFCCs"),
                                    (ddmfccs, "Delta-delta MFCCs")]):
        plt.subplot(3, 1, i + 1)
        zaftpu.mfccshow(m, len(mono), sr, xtick_step=1)
        plt.title(title)
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, "mfcc.png"))
    plt.close()
    return {"mfccs": mfccs, "dmfccs": dmfccs, "ddmfccs": ddmfccs}


def example_cqtkernel(outdir):
    """Compute and display a CQT kernel."""
    kernel = zaftpu.cqtkernel(44100, 24, 55, 22050)
    plt.figure(figsize=(14, 5))
    plt.imshow(np.abs(kernel.toarray()), aspect="auto", cmap="jet",
               origin="lower")
    plt.title("Magnitude CQT kernel")
    plt.xlabel("FFT index")
    plt.ylabel("CQT index")
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, "cqtkernel.png"))
    plt.close()
    return {"kernel_mag": np.abs(kernel.toarray())}


def example_cqtspectrogram(outdir):
    """Compute and display a CQT spectrogram."""
    audio, sr = load_audio()
    mono = audio.mean(axis=1)
    kernel = zaftpu.cqtkernel(sr, 24, 55, 3520)
    spec = np.asarray(zaftpu.cqtspectrogram(mono, sr, 25, kernel))
    plt.figure(figsize=(14, 5))
    zaftpu.cqtspecshow(spec, 25, 24, 55, xtick_step=1)
    plt.title("CQT spectrogram (dB)")
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, "cqtspectrogram.png"))
    plt.close()
    return {"spec": spec}


def example_cqtchromagram(outdir):
    """Compute and display a CQT chromagram."""
    audio, sr = load_audio()
    mono = audio.mean(axis=1)
    kernel = zaftpu.cqtkernel(sr, 24, 55, 3520)
    chroma = np.asarray(zaftpu.cqtchromagram(mono, sr, 25, 24, kernel))
    plt.figure(figsize=(14, 3))
    zaftpu.cqtchromshow(chroma, 25, xtick_step=1)
    plt.title("CQT chromagram")
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, "cqtchromagram.png"))
    plt.close()
    return {"chroma": chroma}


def example_dct(outdir):
    """Compute the 4 DCTs and compare to SciPy's."""
    import scipy.fftpack

    audio, sr = load_audio()
    segment = audio.mean(axis=1)[:1024]
    outs = {}
    plt.figure(figsize=(14, 7))
    for i, ttype in enumerate((1, 2, 3, 4)):
        mine = np.asarray(zaftpu.dct(segment, ttype))
        ref = scipy.fftpack.dct(segment, type=ttype, norm="ortho")
        outs[f"dct{ttype}"] = mine
        outs[f"dct{ttype}_diff"] = mine - ref
        plt.subplot(3, 4, i + 1)
        plt.plot(mine)
        plt.autoscale(tight=True)
        plt.title(f"DCT-{['I', 'II', 'III', 'IV'][i]}")
        plt.subplot(3, 4, i + 5)
        plt.plot(ref)
        plt.autoscale(tight=True)
        plt.title("SciPy")
        plt.subplot(3, 4, i + 9)
        plt.plot(mine - ref)
        plt.autoscale(tight=True)
        plt.title("Difference")
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, "dct.png"))
    plt.close()
    return outs


def example_dst(outdir):
    """Compute the 4 DSTs and verify their inverses recover the audio."""
    audio, sr = load_audio()
    segment = audio.mean(axis=1)[:1024]
    pairs = [(1, 1), (2, 3), (3, 2), (4, 4)]
    outs = {}
    plt.figure(figsize=(14, 7))
    for i, (fwd, inv) in enumerate(pairs):
        fwd_out = np.asarray(zaftpu.dst(segment, fwd))
        rec = np.asarray(zaftpu.dst(fwd_out, inv))
        outs[f"dst{fwd}"] = fwd_out
        outs[f"dst{fwd}_recon_err"] = rec - segment
        plt.subplot(3, 4, i + 1)
        plt.plot(fwd_out)
        plt.autoscale(tight=True)
        plt.title(f"DST-{['I','II','III','IV'][i]}")
        plt.subplot(3, 4, i + 5)
        plt.plot(rec)
        plt.autoscale(tight=True)
        plt.title("Inverse")
        plt.subplot(3, 4, i + 9)
        plt.plot(rec - segment)
        plt.autoscale(tight=True)
        plt.title("Inverse - original")
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, "dst.png"))
    plt.close()
    return outs


def example_mdct(outdir):
    """Compute and display the MDCT with the AC-3 KBD window."""
    audio, sr = load_audio()
    mono = audio.mean(axis=1)
    window = kbd(512, 5.0)
    coeffs = np.abs(np.asarray(zaftpu.mdct(mono, window)))
    plt.figure(figsize=(14, 7))
    zaftpu.specshow(coeffs, len(mono), sr, xtick_step=1, ytick_step=1000)
    plt.title("MDCT (dB)")
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, "mdct.png"))
    plt.close()
    return {"coeffs": coeffs}


def example_imdct(outdir):
    """Verify that the MDCT (Vorbis window) is perfectly invertible."""
    audio, sr = load_audio()
    mono = audio.mean(axis=1)
    window = vorbis(2048)
    coeffs = zaftpu.mdct(mono, window)
    rec = np.asarray(zaftpu.imdct(coeffs, window))[:len(mono)]
    diff = mono[:len(rec)] - rec
    y_max = np.max(np.abs(diff))
    plt.figure(figsize=(14, 7))
    for i, (sig, title, ylim) in enumerate(
            [(mono, "Original signal", 1),
             (rec, "Resynthesized signal", 1),
             (diff, "Original - resynthesized", y_max)]):
        plt.subplot(3, 1, i + 1)
        zaftpu.sigplot(sig, sr, xtick_step=1)
        plt.ylim(-ylim, ylim)
        plt.title(title)
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, "imdct.png"))
    plt.close()
    return {"rec": rec, "diff": diff}


def example_griffinlim(outdir):
    """Reconstruct audio from a magnitude spectrogram (beyond the reference:
    fast Griffin-Lim phase recovery, one fused device loop)."""
    audio, sr = load_audio()
    mono = audio.mean(axis=1)[:10 * sr].astype(np.float32)
    wl, window, step = _analysis_params(sr)
    window = window.astype(np.float32)
    magnitude = np.abs(np.asarray(zaftpu.stft(mono, window, step)))[:wl // 2 + 1]
    rebuilt = np.asarray(zaftpu.griffin_lim(magnitude, window, step,
                                            iterations=50))
    zaftpu.wavwrite(rebuilt, sr, os.path.join(outdir, "griffinlim.wav"))
    plt.figure(figsize=(14, 7))
    for i, (sig, title) in enumerate([(mono, "Original signal"),
                                      (rebuilt, "Griffin-Lim reconstruction")]):
        plt.subplot(2, 1, i + 1)
        zaftpu.sigplot(sig, sr, xtick_step=1)
        plt.ylim(-1, 1)
        plt.title(title)
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, "griffinlim.png"))
    plt.close()
    return {"rebuilt": rebuilt}


def array_stats(arr):
    """Statistical fingerprint of one plotted array.

    Pins the visual layer against the reference's golden images
    (reference README.md:100,178,221 embeds images/*.png as expected
    outputs): shape, finite fraction, value range, mean, and RMS of the
    matrix behind each figure. Committed expectations live in
    tests/golden/example_stats.json (tests/make_example_stats.py).
    """
    a = np.asarray(arr, dtype=np.float64)
    finite = np.isfinite(a)
    af = a[finite] if finite.any() else np.zeros(1)
    return {
        "shape": list(a.shape),
        "finite_frac": float(finite.mean()),
        "min": float(af.min()),
        "max": float(af.max()),
        "mean": float(af.mean()),
        "rms": float(np.sqrt(np.mean(af * af))),
    }


def fingerprint(outs):
    """Per-array stats for one example's returned plotted arrays."""
    return {name: array_stats(val) for name, val in sorted(outs.items())}


ALL = [example_stft, example_istft, example_melfilterbank,
       example_melspectrogram, example_mfcc, example_cqtkernel,
       example_cqtspectrogram, example_cqtchromagram, example_dct,
       example_dst, example_mdct, example_imdct, example_griffinlim]


def main(outdir="example_output"):
    os.makedirs(outdir, exist_ok=True)
    for fn in ALL:
        print(f"running {fn.__name__} ...", flush=True)
        fn(outdir)
    print(f"wrote {len(ALL)} figures to {outdir}/")


if __name__ == "__main__":
    main(*sys.argv[1:2])
