"""The plain JAX paths every transform runs, against float64 oracles.

Framing + window, overlap-add, the analysis front end (framing -> rfft), the
full-spectrum STFT, ISTFT/IMDCT synthesis, the mel/spectrogram rows and the
CQT slab loop are each checked in float32 against a NumPy float64 oracle (or
the library's own float64 path, which the golden tests hold to the
reference) at the ``(window, hop, frames)`` grids the framework's earlier
hand-written kernels were tested on — both FFT engines, and again under the
``ZAFTPU_PRECISION=split4`` dial. The platform choices (FFT engine, bf16
dot) are checked with the platform monkeypatched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import zaftpu
from zaftpu.core import fft as cfft
from zaftpu.core import frame as cframe
from zaftpu.core import policy
from zaftpu.core.windows import hamming, vorbis

FRAMING_GRID = [(2048, 1024, 37), (2048, 1024, 256), (512, 256, 300),
                (1024, 128, 64)]
OLA_GRID = [(2048, 1024, 37), (512, 256, 300), (1024, 128, 40),
            (512, 256, 257), (2048, 1024, 255), (1024, 128, 509)]
ANALYSIS_GRID = [(2048, 1024, 37), (2048, 1024, 300), (512, 256, 150),
                 (1024, 128, 40)]
SYNTH_GRID = [(2048, 1024, 37), (2048, 1024, 300), (512, 128, 64),
              (256, 128, 3), (2048, 1024, 5)]
IMDCT_GRID = [(1024, 64), (1024, 7), (128, 40)]
MEL_GRID = [(2048, 1024, 37), (512, 256, 150)]
ENGINES = ["native", "matmul"]


def _snr(ref, est):
    ref = np.asarray(ref)
    err = np.asarray(est) - ref
    return 10 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(np.abs(err) ** 2))


def _frames_np(padded, wl, step, t):
    return np.stack([padded[j * step:j * step + wl] for j in range(t)])


def _ola_np(frames, step):
    t, wl = frames.shape
    out = np.zeros(t * step + wl - step)
    for j in range(t):
        out[j * step:j * step + wl] += frames[j]
    return out


def _padded(rng, wl, step, t):
    return rng.standard_normal(t * step + wl - step).astype(np.float32)


@pytest.fixture()
def engine(request, monkeypatch):
    monkeypatch.setenv("ZAFTPU_FFT", request.param)
    return request.param


@pytest.mark.parametrize("wl,step,t", FRAMING_GRID)
def test_windowed_frames_matches_oracle(wl, step, t):
    padded = _padded(np.random.default_rng(0), wl, step, t)
    win = hamming(wl)
    out = np.asarray(cframe.windowed_frames(
        jnp.asarray(padded), jnp.asarray(win.astype(np.float32)), wl, step,
        t))
    ref = _frames_np(padded.astype(np.float64), wl, step, t) * win
    assert out.shape == (t, wl) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("wl,step,t", OLA_GRID)
def test_overlap_add_matches_oracle(wl, step, t):
    frames = np.random.default_rng(1).standard_normal((t, wl))
    out = np.asarray(cframe.overlap_add(jnp.asarray(frames, jnp.float32),
                                        step))
    assert out.shape == (t * step + wl - step,)
    np.testing.assert_allclose(out, _ola_np(frames, step), atol=2e-6 * wl
                               / step)


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
@pytest.mark.parametrize("wl,step,t", ANALYSIS_GRID)
def test_windowed_frames_rfft_matches_oracle(wl, step, t, engine):
    padded = _padded(np.random.default_rng(2), wl, step, t)
    win = hamming(wl)
    out = np.asarray(cfft.windowed_frames_rfft(
        jnp.asarray(padded), jnp.asarray(win.astype(np.float32)), wl, step,
        t))
    ref = np.fft.rfft(_frames_np(padded.astype(np.float64), wl, step, t)
                      * win, axis=-1)
    assert out.shape == (t, wl // 2 + 1) and out.dtype == np.complex64
    assert _snr(ref, out) > 115.0


@pytest.mark.parametrize("wl,step,t", ANALYSIS_GRID)
def test_stft_full_spectrum_matches_oracle(wl, step, t):
    """The public STFT (rfft + conjugate-symmetric mirror + transpose) vs
    NumPy's full complex FFT of the reference's centered frames."""
    n = (t - 1) * step
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    win = hamming(wl)
    out = np.asarray(zaftpu.stft(x, win.astype(np.float32), step))
    pad_front, pad_back, t_ref = cframe.stft_padding(n, wl, step)
    assert t_ref == t and out.shape == (wl, t)
    padded = np.pad(x.astype(np.float64), (pad_front, pad_back))
    ref = np.fft.fft(_frames_np(padded, wl, step, t) * win, axis=-1).T
    assert _snr(ref, out) > 115.0


def _synthesis_oracle(spectra, step, gain):
    frames = np.real(np.fft.ifft(spectra.T, axis=-1))
    return _ola_np(frames, step) / gain


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
@pytest.mark.parametrize("n,step,t", SYNTH_GRID)
def test_synthesis_ola_matches_oracle(n, step, t, engine):
    """ISTFT synthesis (real inverse FFT + OLA + COLA gain) of arbitrary,
    non-Hermitian spectra (the reference's real(ifft) semantics)."""
    rng = np.random.default_rng(4)
    spectra = (rng.standard_normal((n, t))
               + 1j * rng.standard_normal((n, t)))
    gain = 1.3678794
    out = np.asarray(cfft.synthesis_ola(jnp.asarray(spectra, jnp.complex64),
                                        step, gain))
    ref = _synthesis_oracle(spectra, step, gain)
    assert out.shape == ref.shape and out.dtype == np.float32
    assert _snr(ref, out) > 115.0


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
@pytest.mark.parametrize("f,t", IMDCT_GRID)
def test_imdct_matches_oracle(f, t, engine):
    """f32 IMDCT (window folded into the operator on the GEMM engine) vs
    the float64 path."""
    coeffs = np.random.default_rng(5).standard_normal((f, t))
    win = vorbis(2 * f)
    out = np.asarray(zaftpu.imdct(coeffs.astype(np.float32),
                                  win.astype(np.float32)))
    ref = np.asarray(zaftpu.imdct(coeffs, win))
    assert out.shape == ref.shape and out.dtype == np.float32
    assert _snr(ref, out) > 115.0


def _mel_oracle(x, win, step, fbank, power):
    wl = len(win)
    pad_front, pad_back, t = cframe.stft_padding(len(x), wl, step)
    padded = np.pad(x.astype(np.float64), (pad_front, pad_back))
    mag = np.abs(np.fft.rfft(_frames_np(padded, wl, step, t) * win,
                             axis=-1))[:, 1:]
    return (mag ** 2 if power else mag) @ fbank.T


@pytest.mark.parametrize("feature", ["melspectrogram", "mfcc"])
@pytest.mark.parametrize("wl,step,t", MEL_GRID)
def test_mel_rows_match_oracle(wl, step, t, feature):
    """Mel rows (magnitude for melspectrogram, power for MFCC) and the MFCC
    cepstra against NumPy."""
    from zaftpu.features.mel import _LOG_EPS, dct_ii_ortho_matrix

    sr = 8000 if wl == 512 else 44100
    x = np.random.default_rng(6).standard_normal((t - 1) * step)
    win = hamming(wl)
    fbank = zaftpu.melfilterbank(sr, wl, 40)
    x32, w32 = x.astype(np.float32), win.astype(np.float32)
    if feature == "melspectrogram":
        out = np.asarray(zaftpu.melspectrogram(x32, w32, step, fbank))
        ref = _mel_oracle(x, win, step, fbank, power=False).T
        assert _snr(ref, out) > 115.0
    else:
        out = np.asarray(zaftpu.mfcc(x32, w32, step, fbank, 20))
        mel = _mel_oracle(x, win, step, fbank, power=True)
        ref = (np.log(mel + _LOG_EPS) @ dct_ii_ortho_matrix(40).T)[:, 1:21].T
        np.testing.assert_allclose(out, ref, atol=5e-3)
    assert out.shape[-1] == t


@pytest.mark.parametrize("wl,step,t", MEL_GRID)
def test_spectrogram_rows_match_oracle(wl, step, t):
    x = np.random.default_rng(7).standard_normal((t - 1) * step)
    win = hamming(wl)
    out = np.asarray(zaftpu.spectrogram(x.astype(np.float32),
                                        win.astype(np.float32), step))
    pad_front, pad_back, _ = cframe.stft_padding(len(x), wl, step)
    padded = np.pad(x, (pad_front, pad_back))
    ref = np.abs(np.fft.rfft(_frames_np(padded, wl, step, t) * win,
                             axis=-1))[:, 1:].T
    assert out.shape == (wl // 2, t)
    assert _snr(ref, out) > 115.0


@pytest.mark.parametrize("block", ["16", "1024"])
def test_cqt_slab_loop_matches_oracle(block, monkeypatch):
    """The f32 CQT (time-domain operator as hop-width slab GEMMs, blocked
    under lax.map) vs the f64 path (rfft + reduced kernel), at two block
    sizes: a block boundary inside the signal and one block for all."""
    monkeypatch.setenv("ZAFTPU_CQT_BLOCK", block)
    sr, time_res = 8000, 25
    kern = zaftpu.cqtkernel(sr, 12, 110.0, 880.0)
    x = np.random.default_rng(8).standard_normal(2 * sr)
    out = np.asarray(zaftpu.cqtspectrogram(x.astype(np.float32), sr,
                                           time_res, kern))
    ref = np.asarray(zaftpu.cqtspectrogram(x, sr, time_res, kern))
    assert out.shape == ref.shape == (kern.number_frequencies,
                                      2 * sr // round(sr / time_res))
    assert _snr(ref, out) > 115.0


def test_cqt_chromagram_matches_oracle():
    sr, time_res = 8000, 25
    kern = zaftpu.cqtkernel(sr, 12, 110.0, 880.0)
    x = np.random.default_rng(9).standard_normal(2 * sr)
    out = np.asarray(zaftpu.cqtchromagram(x.astype(np.float32), sr,
                                          time_res, 12, kern))
    ref = np.asarray(zaftpu.cqtchromagram(x, sr, time_res, 12, kern))
    np.testing.assert_allclose(out, ref, atol=5e-4)


# -- the split4 precision dial on the GEMM engine ---------------------------

@pytest.fixture()
def split4(monkeypatch):
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")


@pytest.mark.parametrize("wl,step,t", ANALYSIS_GRID)
def test_windowed_frames_rfft_split4(wl, step, t, split4):
    """The 4-pass bf16-split DFT GEMMs clear ~100 dB vs f64 (one bf16 pass
    would land near 50 dB)."""
    padded = _padded(np.random.default_rng(10), wl, step, t)
    win = hamming(wl)
    out = np.asarray(cfft.windowed_frames_rfft(
        jnp.asarray(padded), jnp.asarray(win.astype(np.float32)), wl, step,
        t))
    ref = np.fft.rfft(_frames_np(padded.astype(np.float64), wl, step, t)
                      * win, axis=-1)
    assert 96.0 < _snr(ref, out) < 125.0


@pytest.mark.parametrize("n,step,t", SYNTH_GRID)
def test_synthesis_ola_split4(n, step, t, split4):
    rng = np.random.default_rng(11)
    spectra = (rng.standard_normal((n, t))
               + 1j * rng.standard_normal((n, t)))
    out = np.asarray(cfft.synthesis_ola(jnp.asarray(spectra, jnp.complex64),
                                        step, 2.0))
    assert 96.0 < _snr(_synthesis_oracle(spectra, step, 2.0), out) < 125.0


@pytest.mark.parametrize("f,t", IMDCT_GRID)
def test_imdct_split4(f, t, split4):
    coeffs = np.random.default_rng(12).standard_normal((f, t))
    win = vorbis(2 * f)
    out = np.asarray(zaftpu.imdct(coeffs.astype(np.float32),
                                  win.astype(np.float32)))
    ref = np.asarray(zaftpu.imdct(coeffs, win))
    assert 96.0 < _snr(ref, out)


@pytest.mark.parametrize("feature", ["melspectrogram", "mfcc"])
def test_mel_split4(feature, split4):
    """The mel/DCT operators are narrow (N < 256): split4 leaves them at
    the exact scheme, so only the DFT GEMMs feeding them are split."""
    wl, step, t = MEL_GRID[0]
    x = np.random.default_rng(13).standard_normal((t - 1) * step)
    win = hamming(wl)
    fbank = zaftpu.melfilterbank(44100, wl, 40)
    fn = getattr(zaftpu, feature)
    args = (step, fbank) + ((20,) if feature == "mfcc" else ())
    out = np.asarray(fn(x.astype(np.float32), win.astype(np.float32), *args))
    ref = np.asarray(fn(x, win, *args))
    assert _snr(ref, out) > 80.0


# -- platform choices --------------------------------------------------------

def _dot_operand_dtypes(fn, *args):
    # A fresh callable per call: make_jaxpr caches traces by function, and
    # the platform is read at trace time.
    jaxpr = jax.make_jaxpr(lambda *a: fn(*a))(*args)
    return [tuple(str(v.aval.dtype) for v in e.invars)
            for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]


@pytest.mark.parametrize("backend,operands", [("gpu", ("bfloat16",) * 2),
                                              ("cpu", ("float32",) * 2)])
def test_bf16_dot_by_platform(backend, operands, monkeypatch):
    """Off the CPU the bf16 dot is native (bf16 x bf16 -> f32); the CPU,
    which has no such dot thunk, runs the exact f32 emulation."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    a = jnp.zeros((4, 8), jnp.bfloat16)
    b = jnp.zeros((8, 3), jnp.bfloat16)
    assert _dot_operand_dtypes(policy.bf16_dot, a, b) == [operands]
    assert policy.bf16_dot(a, b).dtype == jnp.float32


def test_split4_uses_native_bf16_dots_off_cpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    a = jnp.zeros((8, 64), jnp.float32)
    b = jnp.zeros((64, 256), jnp.float32)
    dots = _dot_operand_dtypes(policy._split4_matmul, a, b)
    assert dots == [("bfloat16", "bfloat16")] * 4


def test_operator_matmul_bf16_operator_off_cpu(monkeypatch):
    """A bf16 operator (the compute_dtype("bfloat16") dial) lowers the
    activation to bf16 and runs one native bf16 dot off the CPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    a = jnp.zeros((4, 8), jnp.float32)
    b = jnp.zeros((8, 3), jnp.bfloat16)
    assert _dot_operand_dtypes(policy.operator_matmul, a, b) == [
        ("bfloat16", "bfloat16")]
    assert policy.operator_matmul(a, b).dtype == jnp.float32
