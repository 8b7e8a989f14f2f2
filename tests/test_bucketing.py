"""Length-bucketing retrace hygiene.

Sharded transforms pad signal lengths up to a frames-per-shard quantum
(``ZAFTPU_BUCKET_FRAMES``) and slice true-length outputs eagerly, so an
hour-scale sweep over many lengths reuses one compiled program per bucket
instead of retracing per length.
"""

import jax
import numpy as np
import pytest

import zaftpu
from zaftpu.core.windows import hamming, vorbis
from zaftpu.sharding import (
    cqtspectrogram_sharded,
    imdct_sharded,
    istft_sharded,
    make_mesh,
    mdct_sharded,
    stft_sharded,
)
from zaftpu.sharding import sharded as _sharded

WL, STEP = 512, 256


@pytest.fixture(scope="module")
def mesh():
    devices = jax.devices()
    if len(devices) < 4:
        devices = jax.devices("cpu")
    if len(devices) < 4:
        pytest.skip("needs 4 virtual devices")
    return make_mesh(4, devices=devices)


def test_one_trace_serves_many_lengths(mesh, monkeypatch):
    """In split mode (ZAFTPU_SHARDED_FUSE=0 — the many-length sweep
    configuration) the jitted sharded STFT core must compile once per
    bucket, not once per signal length. The default fused mode instead
    trades per-length retraces for single-program throughput; its
    correctness across lengths is gated below and in
    tests/test_sharding.py."""
    monkeypatch.setenv("ZAFTPU_SHARDED_FUSE", "0")
    monkeypatch.setenv("ZAFTPU_BUCKET_FRAMES", "64")
    win = hamming(WL).astype(np.float32)
    rng = np.random.default_rng(0)
    before = _sharded._stft_full_sharded._cache_size()
    # 5 different lengths, all inside the 4*64-frame bucket
    for n in (20_000, 25_000, 33_333, 40_001, 50_000):
        out = stft_sharded(rng.standard_normal(n).astype(np.float32), win,
                           STEP, mesh)
        assert out.shape[-1] == -(-(n + 2 * (WL // 2) - WL) // STEP) + 1
    after = _sharded._stft_full_sharded._cache_size()
    assert after - before == 1, f"expected 1 new trace, got {after - before}"


@pytest.mark.parametrize("fuse", ["auto", "0"])
def test_bucketed_stft_matches_unsharded(mesh, monkeypatch, fuse):
    """Correctness at awkward lengths under a large quantum: bucketing must
    change shapes only, never values — in BOTH sharded program structures
    (fused single-program default and split bucketed-core mode)."""
    monkeypatch.setenv("ZAFTPU_SHARDED_FUSE", fuse)
    monkeypatch.setenv("ZAFTPU_BUCKET_FRAMES", "128")
    win = hamming(WL)
    rng = np.random.default_rng(1)
    for n in (WL + 1, 10_007, 30_000):
        x = rng.standard_normal(n)
        ref = np.asarray(zaftpu.stft(x, win, STEP))
        out = np.asarray(stft_sharded(x, win, STEP, mesh))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-12)
        rec_ref = np.asarray(zaftpu.istft(ref, win, STEP))
        rec = np.asarray(istft_sharded(out, win, STEP, mesh))
        assert rec.shape == rec_ref.shape
        np.testing.assert_allclose(rec, rec_ref, atol=1e-12)


def test_bucketed_mdct_roundtrip_matches(mesh, monkeypatch):
    monkeypatch.setenv("ZAFTPU_BUCKET_FRAMES", "128")
    tdac = vorbis(WL)
    rng = np.random.default_rng(2)
    for n in (3 * WL + 17, 20_011):
        x = rng.standard_normal(n)
        ref = np.asarray(zaftpu.mdct(x, tdac))
        out = np.asarray(mdct_sharded(x, tdac, mesh))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-12)
        rec_ref = np.asarray(zaftpu.imdct(ref, tdac))
        rec = np.asarray(imdct_sharded(out, tdac, mesh))
        assert rec.shape == rec_ref.shape
        np.testing.assert_allclose(rec, rec_ref, atol=1e-12)


def test_bucketed_cqt_matches(mesh, monkeypatch):
    monkeypatch.setenv("ZAFTPU_BUCKET_FRAMES", "32")
    kern = zaftpu.cqtkernel(8000, 12, 110.0, 880.0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(8000 * 2 + 123).astype(np.float32)
    ref = np.asarray(zaftpu.cqtspectrogram(x, 8000, 25, kern))
    out = np.asarray(cqtspectrogram_sharded(x, 8000, 25, kern, mesh))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=5e-4)


def test_bucketing_disabled(mesh, monkeypatch):
    """ZAFTPU_BUCKET_FRAMES=0 restores exact minimal padding."""
    monkeypatch.setenv("ZAFTPU_BUCKET_FRAMES", "0")
    win = hamming(WL)
    x = np.random.default_rng(4).standard_normal(10_000)
    ref = np.asarray(zaftpu.stft(x, win, STEP))
    out = np.asarray(stft_sharded(x, win, STEP, mesh))
    np.testing.assert_allclose(out, ref, atol=1e-12)
