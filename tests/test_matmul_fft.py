"""Four-step matmul FFT vs NumPy's FFT."""

import jax.numpy as jnp
import numpy as np
import pytest

from zaftpu.core.fft import matmul_fft, matmul_rfft

RNG = np.random.default_rng(7)


@pytest.mark.parametrize("n", [256, 1024, 4096, 32768])
def test_matches_numpy_f64(n):
    x = RNG.standard_normal(n)
    mine = np.asarray(matmul_fft(x))
    ref = np.fft.fft(x)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(mine, ref, atol=1e-10 * scale)


@pytest.mark.parametrize("n", [1024, 32768])
def test_matches_numpy_f32(n):
    x = RNG.standard_normal(n).astype(np.float32)
    mine = np.asarray(matmul_fft(x))
    assert mine.dtype == np.complex64
    ref = np.fft.fft(x.astype(np.float64))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(mine, ref, atol=5e-6 * scale)


def test_complex_input():
    x = RNG.standard_normal(512) + 1j * RNG.standard_normal(512)
    np.testing.assert_allclose(np.asarray(matmul_fft(x)), np.fft.fft(x),
                               atol=1e-10 * 512)


def test_batched():
    x = RNG.standard_normal((5, 1024))
    mine = np.asarray(matmul_fft(x))
    ref = np.fft.fft(x, axis=-1)
    np.testing.assert_allclose(mine, ref, atol=1e-9 * np.abs(ref).max())


def test_rfft_half():
    x = RNG.standard_normal(2048)
    np.testing.assert_allclose(np.asarray(matmul_rfft(x)),
                               np.fft.rfft(x), atol=1e-9 * 2048)


def test_non_power_of_two_raises():
    with pytest.raises(ValueError):
        matmul_fft(RNG.standard_normal(1000))


def test_engine_switch_stft_istft(monkeypatch):
    """ZAFTPU_FFT=matmul routes the whole STFT/ISTFT round trip through the
    four-step matmul engine with the same results."""
    import zaftpu
    from zaftpu.core.windows import hamming

    sig = RNG.standard_normal(16384).astype(np.float32)
    win = hamming(512).astype(np.float32)
    base_spec = np.asarray(zaftpu.stft(sig, win, 256))
    base_rec = np.asarray(zaftpu.istft(base_spec, win, 256))

    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    # jit caches key on shapes, not env — use different length to force
    # retrace, then compare against the equivalent native run.
    sig2 = sig[:8192]
    spec = np.asarray(zaftpu.stft(sig2, win, 256))
    rec = np.asarray(zaftpu.istft(spec, win, 256))
    monkeypatch.delenv("ZAFTPU_FFT")
    ref_spec = np.asarray(zaftpu.stft(sig2.astype(np.float64), win.astype(np.float64), 256))
    np.testing.assert_allclose(spec, ref_spec, atol=2e-4)
    ref_rec = np.asarray(zaftpu.istft(ref_spec, win, 256))
    np.testing.assert_allclose(rec, ref_rec, atol=2e-4)


def test_engine_switch_mdct(monkeypatch):
    import zaftpu
    from zaftpu.core.windows import vorbis

    sig = RNG.standard_normal(10000).astype(np.float32)
    win = vorbis(512).astype(np.float32)
    ref = np.asarray(zaftpu.mdct(sig.astype(np.float64), vorbis(512)))
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    out = np.asarray(zaftpu.mdct(sig, win))
    rec = np.asarray(zaftpu.imdct(out, win))
    monkeypatch.delenv("ZAFTPU_FFT")
    np.testing.assert_allclose(out, ref, atol=2e-3)
    m = min(len(sig), len(rec))
    err = rec[:m] - sig[:m]
    snr = 10 * np.log10((sig[:m] ** 2).sum() / (err ** 2).sum())
    assert snr > 80


class TestDirectDft:
    """Direct DFT-as-GEMM mode: full-width matmuls for small N (the
    STFT/ISTFT hot-path formulation — contraction dim N instead of the
    four-step's sqrt(N))."""

    @pytest.mark.parametrize("n", [96, 441, 2048])  # non-pow2 allowed
    def test_rfft_matches_numpy_f64(self, n):
        from zaftpu.core.fft import direct_rfft

        x = RNG.standard_normal((4, n))
        got = np.asarray(direct_rfft(jnp.asarray(x)))
        np.testing.assert_allclose(got, np.fft.rfft(x, axis=-1),
                                   rtol=1e-10, atol=1e-10 * n)

    def test_rfft_f32_snr(self):
        from zaftpu.core.fft import direct_rfft

        x = RNG.standard_normal((8, 2048)).astype(np.float32)
        got = np.asarray(direct_rfft(jnp.asarray(x)))
        assert got.dtype == np.complex64
        ref = np.fft.rfft(x.astype(np.float64), axis=-1)
        err = np.abs(got - ref)
        snr = 10 * np.log10(float((np.abs(ref) ** 2).sum())
                            / float((err ** 2).sum()))
        assert snr > 110.0, snr

    def test_real_ifft_non_hermitian(self):
        """Direct inverse keeps the reference's real(ifft(Z)) semantics for
        arbitrary (masked, non-Hermitian) spectra — zaf.py:223."""
        from zaftpu.core.fft import direct_real_ifft

        z = (RNG.standard_normal((3, 512))
             + 1j * RNG.standard_normal((3, 512)))
        z[:, 100:200] = 0.0  # a masked band, deliberately asymmetric
        got = np.asarray(direct_real_ifft(jnp.asarray(z)))
        ref = np.real(np.fft.ifft(z, axis=-1))
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)

    def test_real_ifft_odd_length(self):
        """The Hermitian-fold weights branch on N parity (no Nyquist bin for
        odd N) — gate an odd length explicitly."""
        from zaftpu.core.fft import direct_real_ifft

        z = (RNG.standard_normal((2, 511))
             + 1j * RNG.standard_normal((2, 511)))
        got = np.asarray(direct_real_ifft(jnp.asarray(z)))
        ref = np.real(np.fft.ifft(z, axis=-1))
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)

    @pytest.mark.parametrize("n", [512, 511, 2048])
    def test_full_from_half_mirror(self, n):
        """The plane-gather mirror (concat + interior-only index gather)
        must reproduce np.fft.fft's full spectrum exactly, even and odd N."""
        from zaftpu.core.fft import full_from_half

        x = RNG.standard_normal((3, n))
        half = np.fft.rfft(x, axis=-1)
        got = np.asarray(full_from_half(jnp.asarray(half), n))
        np.testing.assert_allclose(got, np.fft.fft(x, axis=-1),
                                   rtol=1e-12, atol=1e-12 * n)

    def test_engine_routes_small_n_direct(self, monkeypatch):
        """Under ZAFTPU_FFT=matmul, rfft/real_ifft of n <= DIRECT_MAX use
        the direct GEMMs; DIRECT_MAX=0 falls back to four-step."""
        from zaftpu.core import fft as fft_mod

        monkeypatch.setenv("ZAFTPU_FFT", "matmul")
        x = RNG.standard_normal((2, 1024))
        got = np.asarray(fft_mod.rfft(jnp.asarray(x)))
        np.testing.assert_allclose(got, np.fft.rfft(x, axis=-1),
                                   rtol=1e-10, atol=1e-10 * 1024)
        z = RNG.standard_normal((2, 1024)) + 1j * RNG.standard_normal((2, 1024))
        got_i = np.asarray(fft_mod.real_ifft(jnp.asarray(z)))
        np.testing.assert_allclose(got_i, np.real(np.fft.ifft(z, axis=-1)),
                                   rtol=1e-10, atol=1e-12)
        monkeypatch.setenv("ZAFTPU_FFT_DIRECT_MAX", "0")
        got2 = np.asarray(fft_mod.rfft(jnp.asarray(x)))
        np.testing.assert_allclose(got2, np.fft.rfft(x, axis=-1),
                                   rtol=1e-10, atol=1e-10 * 1024)

    def test_mdct_direct_matches_native_f64(self, monkeypatch):
        """The folded (WL, WL/2) forward / (F, 2F) inverse MDCT matrices
        reproduce the native pre/FFT/post chain to f64 rounding."""
        import zaftpu
        from zaftpu.core.windows import vorbis

        sig = RNG.standard_normal(9000)
        win = vorbis(1024)
        ref_out = np.asarray(zaftpu.mdct(sig, win))
        ref_rec = np.asarray(zaftpu.imdct(ref_out, win))
        monkeypatch.setenv("ZAFTPU_FFT", "matmul")
        out = np.asarray(zaftpu.mdct(sig, win))
        rec = np.asarray(zaftpu.imdct(out, win))
        np.testing.assert_allclose(out, ref_out, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(rec, ref_rec, rtol=1e-9, atol=1e-10)

    def test_mdct_direct_non_pow2_kbd(self, monkeypatch):
        """The direct mode covers the reference's KBD example window
        (length WL-2 = 2046 — not a power of two, so the four-step engine
        never applied; zaf.py:1004-1010)."""
        import zaftpu
        from zaftpu.core.windows import kbd

        sig = RNG.standard_normal(20000)
        win = kbd(2048)  # the reference construction yields WL-2 = 2046
        assert win.shape[0] == 2046
        ref_out = np.asarray(zaftpu.mdct(sig, win))
        monkeypatch.setenv("ZAFTPU_FFT", "matmul")
        out = np.asarray(zaftpu.mdct(sig, win))
        np.testing.assert_allclose(out, ref_out, rtol=1e-10, atol=1e-10)

    def test_stft_istft_round_trip_direct(self, monkeypatch):
        """Whole STFT->ISTFT round trip on the direct-GEMM engine."""
        import zaftpu
        from zaftpu.core.windows import hamming

        monkeypatch.setenv("ZAFTPU_FFT", "matmul")
        sig = RNG.standard_normal(12288).astype(np.float32)
        win = hamming(1024).astype(np.float32)
        spec = np.asarray(zaftpu.stft(sig, win, 512))
        rec = np.asarray(zaftpu.istft(spec, win, 512))
        monkeypatch.delenv("ZAFTPU_FFT")
        ref_spec = np.asarray(zaftpu.stft(sig.astype(np.float64),
                                          win.astype(np.float64), 512))
        np.testing.assert_allclose(spec, ref_spec, atol=2e-4)
        ref_rec = np.asarray(zaftpu.istft(ref_spec,
                                          win.astype(np.float64), 512))
        err = rec.astype(np.float64) - ref_rec
        snr = 10 * np.log10((ref_rec ** 2).sum() / (err ** 2).sum())
        assert snr > 100.0, snr


class TestPackedRfft:
    """Row-packed batched rfft: pairs of real rows ride one complex FFT."""

    @pytest.mark.parametrize("batch", [1, 2, 3, 8])
    @pytest.mark.parametrize("n", [64, 256])
    def test_matches_numpy_rfft_f64(self, batch, n):
        rng = np.random.default_rng(batch * 1000 + n)
        x = rng.standard_normal((batch, n))
        got = np.asarray(matmul_rfft(jnp.asarray(x)))
        np.testing.assert_allclose(got, np.fft.rfft(x, axis=-1),
                                   rtol=1e-10, atol=1e-10)

    def test_matches_numpy_rfft_f32(self):
        rng = np.random.default_rng(7)
        x = rng.standard_normal((6, 2048)).astype(np.float32)
        got = np.asarray(matmul_rfft(jnp.asarray(x)))
        ref = np.fft.rfft(x.astype(np.float64), axis=-1)
        err = np.abs(got - ref)
        snr = 10 * np.log10(float((np.abs(ref) ** 2).sum())
                            / float((err ** 2).sum()))
        assert snr > 120.0, snr

    def test_leading_batch_axes(self):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((2, 5, 128))
        got = np.asarray(matmul_rfft(jnp.asarray(x)))
        np.testing.assert_allclose(got, np.fft.rfft(x, axis=-1),
                                   rtol=1e-10, atol=1e-10)

    def test_single_vector_path(self):
        rng = np.random.default_rng(4)
        x = rng.standard_normal(128)
        got = np.asarray(matmul_rfft(jnp.asarray(x)))
        np.testing.assert_allclose(got, np.fft.rfft(x),
                                   rtol=1e-10, atol=1e-10)


class TestAutoMode:
    def test_auto_selects_engine_by_backend(self, monkeypatch):
        """ZAFTPU_FFT default (auto) = XLA's native FFT on every backend
        (cuFFT on the GPU); explicit matmul/native override either way."""
        import jax

        from zaftpu.core import fft as fft_mod

        monkeypatch.delenv("ZAFTPU_FFT", raising=False)
        for backend in ("cpu", "gpu"):
            monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
            assert fft_mod.engine_selected() is False
            monkeypatch.setenv("ZAFTPU_FFT", "native")
            assert fft_mod.engine_selected() is False
            monkeypatch.setenv("ZAFTPU_FFT", "matmul")
            assert fft_mod.engine_selected() is True
            monkeypatch.delenv("ZAFTPU_FFT")
