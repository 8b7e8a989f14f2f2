"""Generate committed goldens from the reference on the REAL 23-s fixture.

Usage: ``python tests/make_golden_fixture.py`` (requires /root/reference).
Round 1 pinned parity on a 1-s synthetic signal only; this file pins the
reference's outputs on its own universal fixture ``audio_file.wav``
(README.md:727-729) so parity is gated offline against environment drift.

Full outputs are too large to commit (the f64 STFT alone is 32 MB), so each
transform stores (a) a deterministic frame/sample subset bit-exactly and
(b) a whole-array per-frame energy vector as a cheap global checksum.
"""

import os
import sys

import numpy as np

REFERENCE = os.environ.get("ZAF_REFERENCE", "/root/reference")
OUT = os.path.join(os.path.dirname(__file__), "golden", "golden_fixture.npz")

STFT_FRAME_STRIDE = 31   # 992 frames -> 32 committed columns
MDCT_FRAME_STRIDE = 31
SIG_STRIDE = 37          # imdct/istft signals: every 37th sample


def main():
    sys.path.insert(0, REFERENCE)
    import scipy.signal
    import zaf

    x, sr = zaf.wavread(os.path.join(REFERENCE, "audio_file.wav"))
    mono = x.mean(axis=1)

    wl = 2048
    window = scipy.signal.windows.hamming(wl, sym=False)
    step = wl // 2

    stft = zaf.stft(mono, window, step)
    istft = zaf.istft(stft, window, step)

    fbank = zaf.melfilterbank(sr, wl, 40)
    mfcc = zaf.mfcc(mono, window, step, fbank, 20)

    kernel = zaf.cqtkernel(sr, 24, 55, 3520)
    cqtspec = zaf.cqtspectrogram(mono, sr, 25, kernel)
    chroma = zaf.cqtchromagram(mono, sr, 25, 24, kernel)

    vorbis = np.sin(
        np.pi / 2 * np.sin(np.pi / wl * np.arange(0.5, wl + 0.5)) ** 2)
    mdct = zaf.mdct(mono, vorbis)
    imdct = zaf.imdct(mdct, vorbis)

    np.savez_compressed(
        OUT,
        sr=np.array(sr),
        mono_head=mono[: 4 * wl],            # pins the wavread+mean contract
        mono_checksum=np.array([mono.sum(), np.abs(mono).sum()]),
        stft_cols=stft[:, ::STFT_FRAME_STRIDE],
        stft_frame_energy=np.abs(stft).sum(axis=0),
        istft_sub=istft[::SIG_STRIDE],
        istft_head=istft[: 2 * wl],
        mfcc=mfcc,                            # (20, 992): small, keep whole
        cqtspectrogram=cqtspec,               # (144, 575)
        cqtchromagram=chroma,                 # (24, 575)
        mdct_cols=mdct[:, ::MDCT_FRAME_STRIDE],
        mdct_frame_energy=np.abs(mdct).sum(axis=0),
        imdct_sub=imdct[::SIG_STRIDE],
        imdct_head=imdct[: 2 * wl],
        imdct_tail=imdct[-2 * wl:],
    )
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
