"""bf16 operator-GEMM fast-path gates.

``zaftpu.compute_dtype("bfloat16")`` lowers operator-matmul operands to bf16
with f32 accumulation — but only where the operator GEMMs are big enough to
pay (policy.BF16_EXEMPT): the CQT's 32k-contraction operator GEMMs lower,
while MFCC and melspectrogram are exempt (their tiny GEMMs sit next to the
rfft) and must stay bit-identical to the f32 path under the dial.
"""

import numpy as np
import pytest

import zaftpu
from zaftpu.core.windows import hamming

SR, WL, STEP = 44100, 2048, 1024


def _snr(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return 10 * np.log10((ref ** 2).sum() / ((ref - got) ** 2).sum())


@pytest.fixture(scope="module")
def x32():
    return np.random.default_rng(0).standard_normal(SR * 2).astype(np.float32)


@pytest.fixture(scope="module")
def fbank():
    return zaftpu.melfilterbank(SR, WL, 40)


@pytest.fixture(scope="module")
def kern():
    return zaftpu.cqtkernel(SR, 24, 55.0, 3520.0)


def test_bf16_flag_exported():
    assert zaftpu.BF16_SUPPORTED


def test_mel_bf16_exempt(x32, fbank):
    """melspectrogram is roofline-exempt: the dial must not change it."""
    win = hamming(WL).astype(np.float32)
    ref = np.asarray(zaftpu.melspectrogram(x32, win, STEP, fbank))
    with zaftpu.compute_dtype("bfloat16"):
        got = np.asarray(zaftpu.melspectrogram(x32, win, STEP, fbank))
    assert got.dtype == np.float32  # activations/outputs stay f32
    np.testing.assert_array_equal(ref, got)


def test_cqt_bf16_accuracy(x32, kern):
    ref = zaftpu.cqtspectrogram(x32, SR, 25, kern)
    with zaftpu.compute_dtype("bf16"):
        got = zaftpu.cqtspectrogram(x32, SR, 25, kern)
    assert got.dtype == np.float32
    assert _snr(ref, got) > 45.0


def test_mfcc_bf16_exempt(x32, fbank):
    """MFCC is exempt (its (T, 40) x (40, 40) DCT is tiny, and the log
    domain amplifies bf16 noise): the dial must not change it."""
    win = hamming(WL).astype(np.float32)
    ref = np.asarray(zaftpu.mfcc(x32, win, STEP, fbank, 20))
    with zaftpu.compute_dtype("bfloat16"):
        got = np.asarray(zaftpu.mfcc(x32, win, STEP, fbank, 20))
    np.testing.assert_array_equal(ref, got)


def test_policy_restores_exactly(x32, fbank):
    win = hamming(WL).astype(np.float32)
    ref = np.asarray(zaftpu.melspectrogram(x32, win, STEP, fbank))
    with zaftpu.compute_dtype("bfloat16"):
        pass
    again = np.asarray(zaftpu.melspectrogram(x32, win, STEP, fbank))
    np.testing.assert_array_equal(ref, again)


def test_f64_oracle_never_lowered(fbank):
    """The f64 parity path must ignore the bf16 policy entirely."""
    x64 = np.random.default_rng(1).standard_normal(SR)
    win = hamming(WL)
    ref = np.asarray(zaftpu.melspectrogram(x64, win, STEP, fbank))
    with zaftpu.compute_dtype("bfloat16"):
        got = np.asarray(zaftpu.melspectrogram(x64, win, STEP, fbank))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(ref, got)


def test_env_var_path(x32, kern, monkeypatch):
    with zaftpu.compute_dtype("bfloat16"):
        ref = np.asarray(zaftpu.cqtspectrogram(x32, SR, 25, kern))
    monkeypatch.setenv("ZAFTPU_DTYPE", "bfloat16")
    got = np.asarray(zaftpu.cqtspectrogram(x32, SR, 25, kern))
    np.testing.assert_array_equal(ref, got)


def test_invalid_dtype_rejected():
    with pytest.raises(ValueError, match="bfloat16"):
        with zaftpu.compute_dtype("int8"):
            pass


def test_sharded_bf16_equivalent(x32, kern, fbank):
    """The sharded bf16 paths must match single-device bf16 within the f32
    accumulation bound (dots reassociate per shard split — same caveat as
    the f32 sharded CQT gate in test_sharding.py)."""
    import jax

    from zaftpu.sharding import (cqtspectrogram_sharded, make_mesh,
                                 melspectrogram_sharded)

    devices = jax.devices()
    if len(devices) < 4:
        devices = jax.devices("cpu")
    if len(devices) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = make_mesh(4, devices=devices)
    win = hamming(WL).astype(np.float32)
    with zaftpu.compute_dtype("bfloat16"):
        ref_c = np.asarray(zaftpu.cqtspectrogram(x32, SR, 25, kern))
        got_c = np.asarray(cqtspectrogram_sharded(x32, SR, 25, kern, mesh))
        ref_m = np.asarray(zaftpu.melspectrogram(x32, win, STEP, fbank))
        got_m = np.asarray(melspectrogram_sharded(x32, win, STEP, fbank,
                                                  mesh))
    np.testing.assert_allclose(got_c, ref_c, atol=5e-4)
    np.testing.assert_allclose(got_m, ref_m, rtol=1e-4, atol=1e-6)

def test_f32_matmul_requests_highest_precision():
    """The f32 operator-matmul path must request Precision.HIGHEST: without
    it XLA may run an f32 matmul at reduced precision (TF32 on the GPU,
    about three decimal digits). CPU tests cannot observe the truncation
    itself, so pin the precision request in the jaxpr (tests/test_gpu.py
    measures it on a card).
    """
    import jax
    import jax.numpy as jnp

    from zaftpu.core import policy

    jaxpr = jax.make_jaxpr(policy.operator_matmul)(
        jnp.zeros((4, 8), jnp.float32), jnp.zeros((8, 3), jnp.float32))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots, "operator_matmul f32 path must lower to dot_general"
    for eqn in dots:
        assert eqn.params["precision"] == (
            jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def test_bf16_matmul_stays_single_pass():
    """The bf16 path must NOT request HIGHEST (that would defeat the one-pass
    bf16 speedup): default precision with bf16 operands is the fast mode."""
    import jax
    import jax.numpy as jnp

    from zaftpu.core import policy

    jaxpr = jax.make_jaxpr(policy.operator_matmul)(
        jnp.zeros((4, 8), jnp.float32), jnp.zeros((8, 3), jnp.bfloat16))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots
    for eqn in dots:
        assert eqn.params["precision"] != (
            jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)

def test_precision_lever(monkeypatch):
    """ZAFTPU_PRECISION selects the exact-path matmul precision."""
    import jax

    from zaftpu.core import policy

    assert policy.matmul_precision() == jax.lax.Precision.HIGHEST
    monkeypatch.setenv("ZAFTPU_PRECISION", "high")
    assert policy.matmul_precision() == jax.lax.Precision.HIGH
    monkeypatch.setenv("ZAFTPU_PRECISION", "default")
    assert policy.matmul_precision() == jax.lax.Precision.DEFAULT
    monkeypatch.setenv("ZAFTPU_PRECISION", "bogus")
    with pytest.raises(ValueError):
        policy.matmul_precision()


def test_split4_maps_to_highest_for_non_gemm_sites(monkeypatch):
    """Sites that cannot run the manual 4-pass scheme (complex stages, conv
    formulations) must keep full accuracy under ZAFTPU_PRECISION=split4."""
    import jax

    from zaftpu.core import policy

    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    assert policy.matmul_precision() == jax.lax.Precision.HIGHEST
    assert policy.split4_enabled()


def test_split4_matmul_accuracy_and_pass_count():
    """The 4-pass bf16-split GEMM: ~104 dB vs the f64 product (XLA HIGH's
    3-pass scheme caps at ~95 dB by dropping lo@lo), exactly four
    dot_generals in the jaxpr."""
    import jax
    import jax.numpy as jnp

    from zaftpu.core import policy

    rng = np.random.default_rng(1)
    a = rng.standard_normal((64, 256)).astype(np.float32)
    b = rng.standard_normal((256, 128)).astype(np.float32)
    got = np.asarray(policy._split4_matmul(jnp.asarray(a), jnp.asarray(b)))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert _snr(ref, got) > 100.0
    jaxpr = jax.make_jaxpr(policy._split4_matmul)(jnp.asarray(a),
                                                  jnp.asarray(b))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 4


def test_split4_bandwidth_bound_optout(monkeypatch):
    """Traffic-bound GEMMs opt out of split4 and keep one HIGHEST dot:
    explicitly via bandwidth_bound=True, and automatically for narrow
    outputs (N < 256 — the CQT slabs at F=144 measured 18% slower under
    split4, suite.json 2026-08-17; mel/MFCC operators are narrower still).
    Wide operators (the N >= 1024 DFT/MDCT GEMMs) get the 4-pass scheme."""
    import jax
    import jax.numpy as jnp

    from zaftpu.core import policy

    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")

    def dots(fn, *args):
        jaxpr = jax.make_jaxpr(fn)(*args)
        return sum(e.primitive.name == "dot_general"
                   for e in jaxpr.jaxpr.eqns)

    a = jnp.zeros((8, 1764), jnp.float32)
    wide = jnp.zeros((1764, 1024), jnp.float32)
    narrow = jnp.zeros((1764, 144), jnp.float32)
    assert dots(policy.real_matmul, a, wide) == 4
    assert dots(policy.real_matmul, a, narrow) == 1       # auto opt-out
    assert dots(lambda x, y: policy.real_matmul(x, y, bandwidth_bound=True),
                a, wide) == 1                             # explicit opt-out


def test_split4_transform_roundtrips(monkeypatch, x32):
    """End-to-end under ZAFTPU_PRECISION=split4 + the GEMM engine: STFT and
    MDCT round trips must clear the 16-bit-audio 96 dB gate (measured ~108
    dB on CPU's exact bf16 emulation; HIGH measures 94.9 dB on hardware).
    The dial is read at trace time, so caches are cleared around the
    toggle."""
    import jax

    from zaftpu.core.windows import vorbis

    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    jax.clear_caches()
    try:
        win = hamming(WL).astype(np.float32)
        rec = np.asarray(zaftpu.istft(zaftpu.stft(x32, win, STEP), win, STEP))
        n = min(len(rec), len(x32))
        assert 100.0 < _snr(x32[:n], rec[:n]) < 125.0  # split4, not HIGHEST
        tdac = vorbis(WL).astype(np.float32)
        rec2 = np.asarray(zaftpu.imdct(zaftpu.mdct(x32, tdac), tdac))
        n2 = min(len(rec2), len(x32))
        assert 100.0 < _snr(x32[:n2], rec2[:n2]) < 125.0
    finally:
        jax.clear_caches()  # drop split4 traces so later tests retrace


def test_split4_sharded_equivalence(monkeypatch, x32):
    """Sharded transforms must stay value-identical to single-device under
    split4 (same real_matmul scheme inside shard_map)."""
    import jax

    from zaftpu.sharding import make_mesh, stft_sharded

    if len(jax.devices()) < 4:
        pytest.skip("not enough virtual devices")
    monkeypatch.setenv("ZAFTPU_PRECISION", "split4")
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    jax.clear_caches()
    try:
        win = hamming(WL).astype(np.float32)
        ref = np.asarray(zaftpu.stft(x32, win, STEP))
        out = np.asarray(stft_sharded(x32, win, STEP, make_mesh(4)))
        # Same split4 scheme on both sides; the residual is f32
        # accumulation-order noise from the shards' smaller GEMM M (measured
        # 134.7 dB). A sharded path that silently stayed HIGHEST would land
        # at ~113 dB vs the split4 reference — gate above that.
        num = np.sum(np.abs(ref) ** 2)
        den = np.sum(np.abs(ref - out) ** 2)
        assert 10.0 * np.log10(num / den) > 125.0
    finally:
        jax.clear_caches()
