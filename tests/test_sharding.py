"""Sharded == single-device equivalence on a virtual 8-device CPU mesh.

SURVEY.md §4(c): multi-host layouts validated without a cluster via
``--xla_force_host_platform_device_count=8`` (set in conftest.py). Every
sharded transform must reproduce its single-device twin exactly (analysis
paths bit-for-bit; synthesis within one rounding of the boundary sums).
"""

import jax
import numpy as np
import pytest

import zaftpu
from conftest import snr_db
from zaftpu.core.windows import hamming, vorbis
from zaftpu.sharding import (
    cqtchromagram_sharded,
    cqtspectrogram_sharded,
    imdct_sharded,
    istft_sharded,
    make_mesh,
    make_mesh_2d,
    mdct_sharded,
    melspectrogram_sharded,
    mfcc_sharded,
    spectrogram_sharded,
    stft_sharded,
)

WL, STEP = 2048, 1024


@pytest.fixture(scope="module", params=[1, 3, 8])
def mesh(request):
    if len(jax.devices()) < request.param:
        pytest.skip("not enough virtual devices")
    return make_mesh(request.param)


@pytest.fixture(scope="module")
def window():
    return hamming(WL)


def test_stft_sharded_equals_single(signal, window, mesh):
    ref = np.asarray(zaftpu.stft(signal, window, STEP))
    out = np.asarray(stft_sharded(signal, window, STEP, mesh))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-13)


def test_spectrogram_sharded_equals_single(signal, window, mesh):
    ref = np.abs(np.asarray(zaftpu.stft(signal, window, STEP)))[1:WL // 2 + 1]
    out = np.asarray(spectrogram_sharded(signal, window, STEP, mesh))
    np.testing.assert_allclose(out, ref, atol=1e-13)


def test_istft_sharded_equals_single(signal, window, mesh):
    spec = np.asarray(zaftpu.stft(signal, window, STEP))
    ref = np.asarray(zaftpu.istft(spec, window, STEP))
    out = np.asarray(istft_sharded(spec, window, STEP, mesh))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-13)


def test_sharded_roundtrip_snr(signal, window, mesh):
    spec = stft_sharded(signal, window, STEP, mesh)
    rec = np.asarray(istft_sharded(np.asarray(spec), window, STEP, mesh))
    assert snr_db(signal, rec) > 300.0


def test_melspectrogram_sharded(signal, window, mesh):
    fbank = zaftpu.melfilterbank(44100, WL, 40)
    ref = np.asarray(zaftpu.melspectrogram(signal, window, STEP, fbank))
    out = np.asarray(melspectrogram_sharded(signal, window, STEP, fbank,
                                            mesh))
    np.testing.assert_allclose(out, ref, atol=1e-12)


def test_mfcc_sharded(signal, window, mesh):
    fbank = zaftpu.melfilterbank(44100, WL, 40)
    ref = np.asarray(zaftpu.mfcc(signal, window, STEP, fbank, 20))
    out = np.asarray(mfcc_sharded(signal, window, STEP, fbank, 20, mesh))
    np.testing.assert_allclose(out, ref, atol=1e-10)


def test_mdct_sharded(signal, mesh):
    win = vorbis(WL)
    ref = np.asarray(zaftpu.mdct(signal, win))
    out = np.asarray(mdct_sharded(signal, win, mesh))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-13)


def test_imdct_sharded(signal, mesh):
    win = vorbis(WL)
    coeffs = np.asarray(zaftpu.mdct(signal, win))
    ref = np.asarray(zaftpu.imdct(coeffs, win))
    out = np.asarray(imdct_sharded(coeffs, win, mesh))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-13)
    assert snr_db(signal, out) > 250.0


def test_cqt_sharded_f32(signal, mesh):
    """The CQT sharded path is the f32 fused-matmul operator; compare with
    the single-device f32 path."""
    kern = zaftpu.cqtkernel(44100, 24, 55, 3520)
    x32 = signal.astype(np.float32)
    ref = np.asarray(zaftpu.cqtspectrogram(x32, 44100, 25, kern))
    out = np.asarray(cqtspectrogram_sharded(x32, 44100, 25, kern, mesh))
    assert out.shape == ref.shape
    # f32 dot products over 32k terms reassociate differently per shard
    # split; tolerance is the f32 accumulation bound, not bitwise.
    np.testing.assert_allclose(out, ref, atol=5e-4)

    ref_c = np.asarray(zaftpu.cqtchromagram(x32, 44100, 25, 24, kern))
    out_c = np.asarray(cqtchromagram_sharded(x32, 44100, 25, 24, kern, mesh))
    np.testing.assert_allclose(out_c, ref_c, atol=2e-3)


def test_batch_plus_frames_mesh(signal, window):
    """2-D (batch, frames) mesh: DP over signals x SP over frames, in one
    SPMD program — the halo rings run independently inside each batch row."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh2 = make_mesh_2d(2, 4)
    batch = np.stack([signal, signal[::-1]])
    out = np.asarray(stft_sharded(batch, window, STEP, mesh2))
    for i in range(2):
        np.testing.assert_allclose(
            out[i], np.asarray(zaftpu.stft(batch[i], window, STEP)),
            atol=1e-13)
    rec = np.asarray(istft_sharded(out, window, STEP, mesh2))
    for i in range(2):
        assert snr_db(batch[i], rec[i]) > 300.0
    fbank = zaftpu.melfilterbank(44100, WL, 40)
    mf = np.asarray(mfcc_sharded(batch, window, STEP, fbank, 20, mesh2))
    for i in range(2):
        np.testing.assert_allclose(
            mf[i], np.asarray(zaftpu.mfcc(batch[i], window, STEP, fbank, 20)),
            atol=1e-10)
    coeffs = np.asarray(mdct_sharded(batch, vorbis(WL), mesh2))
    rec2 = np.asarray(imdct_sharded(coeffs, vorbis(WL), mesh2))
    for i in range(2):
        assert snr_db(batch[i], rec2[i]) > 250.0


def test_f32_sharded_stft(signal, window, mesh):
    x32 = signal.astype(np.float32)
    w32 = window.astype(np.float32)
    ref = np.asarray(zaftpu.stft(x32, w32, STEP))
    out = np.asarray(stft_sharded(x32, w32, STEP, mesh))
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_large_overlap_tiny_shards(signal):
    """K=4 overlap (step = WL/4) with shards so small that both the analysis
    halo and the OLA spill span multiple shards — exercises multi-hop
    pull_from_right and push_right_sum."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    wl, step = 512, 128
    win = hamming(wl)
    short = signal[:int(9.5 * 8 * step)]  # ~9 frames per shard at 8 shards
    mesh8 = make_mesh(8)
    spec_ref = np.asarray(zaftpu.stft(short, win, step))
    spec = np.asarray(stft_sharded(short, win, step, mesh8))
    np.testing.assert_allclose(spec, spec_ref, atol=1e-13)
    rec_ref = np.asarray(zaftpu.istft(spec_ref, win, step))
    rec = np.asarray(istft_sharded(spec_ref, win, step, mesh8))
    np.testing.assert_allclose(rec, rec_ref, atol=1e-13)

    # Even tinier: 2 frames per shard -> spill spans 2 shards.
    tiny = signal[:8 * 2 * step]
    spec_ref2 = np.asarray(zaftpu.stft(tiny, win, step))
    rec_ref2 = np.asarray(zaftpu.istft(spec_ref2, win, step))
    rec2 = np.asarray(istft_sharded(spec_ref2, win, step, mesh8))
    np.testing.assert_allclose(rec2, rec_ref2, atol=1e-13)


def test_cqt_sharded_f64(signal, mesh):
    """f64 sharded CQT (fused matmul) vs the single-device f64 rfft oracle
    path — different algorithms, same math, f64-tight agreement."""
    kern = zaftpu.cqtkernel(44100, 24, 55, 3520)
    ref = np.asarray(zaftpu.cqtspectrogram(signal, 44100, 25, kern))
    out = np.asarray(cqtspectrogram_sharded(signal, 44100, 25, kern, mesh))
    np.testing.assert_allclose(out, ref, atol=1e-11)


def test_shard_along_placement(signal):
    from zaftpu.sharding import shard_along

    mesh8 = make_mesh(8)
    x = shard_along(signal[:8192], mesh8)
    assert len(x.sharding.device_set) == 8
    out = np.asarray(zaftpu.stft(x, hamming(512), 256))
    np.testing.assert_allclose(
        out, np.asarray(zaftpu.stft(signal[:8192], hamming(512), 256)),
        atol=1e-12)


def test_cqt_tensor_parallel(signal, mesh):
    """TP CQT (kernel frequency axis sharded, signal replicated) must match
    the single-device fused path — SURVEY.md §2.3's tensor-parallel row."""
    from zaftpu.sharding import cqtspectrogram_tp

    kern = zaftpu.cqtkernel(44100, 24, 55, 3520)
    x32 = signal.astype(np.float32)
    ref = np.asarray(zaftpu.cqtspectrogram(x32, 44100, 25, kern))
    out = np.asarray(cqtspectrogram_tp(x32, 44100, 25, kern, mesh))
    assert out.shape == ref.shape
    # Same contraction order per output element (only the channel axis is
    # split), so values match to f32 roundoff.
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)


def test_cqt_tp_f64(signal, mesh):
    from zaftpu.sharding import cqtspectrogram_tp

    kern = zaftpu.cqtkernel(44100, 24, 55, 3520)
    ref = np.asarray(zaftpu.cqtspectrogram(signal, 44100, 25, kern))
    out = np.asarray(cqtspectrogram_tp(signal, 44100, 25, kern, mesh))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-10)


@pytest.mark.parametrize("fuse", ["auto", "0"])
def test_mdct_sharded_direct_engine(signal, mesh, monkeypatch, fuse):
    """Under ZAFTPU_FFT=matmul the sharded MDCT/IMDCT must dispatch to the
    same folded (WL, WL/2)/(F, 2F) GEMM operators as the single-device
    direct path and stay value-identical to it (zaf.py:984-1075 chain) —
    in both the fused single-program mode and the split bucketed mode."""
    monkeypatch.setenv("ZAFTPU_SHARDED_FUSE", fuse)
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    win = vorbis(WL)
    ref = np.asarray(zaftpu.mdct(signal, win))
    out = np.asarray(mdct_sharded(signal, win, mesh))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-13)
    rec_ref = np.asarray(zaftpu.imdct(ref, win))
    rec = np.asarray(imdct_sharded(ref, win, mesh))
    assert rec.shape == rec_ref.shape
    np.testing.assert_allclose(rec, rec_ref, atol=1e-13)
    assert snr_db(signal, rec) > 250.0


@pytest.mark.parametrize("fuse", ["auto", "0"])
def test_istft_sharded_direct_engine(signal, window, mesh, monkeypatch,
                                     fuse):
    """Under ZAFTPU_FFT=matmul the sharded ISTFT runs the engine synthesis
    (prep: transpose + Hermitian fold + frame pad, feeding the folded-GEMM
    core) — as ONE fused program by default, or as the split
    prep-then-bucketed-core pair under ZAFTPU_SHARDED_FUSE=0 — and must
    stay value-identical to the single-device engine synthesis
    (zaf.py:144-243; the CPU suite otherwise never exercises this path
    because the default engine is native)."""
    monkeypatch.setenv("ZAFTPU_SHARDED_FUSE", fuse)
    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    spec = np.asarray(zaftpu.stft(signal, window, STEP))
    ref = np.asarray(zaftpu.istft(spec, window, STEP))
    out = np.asarray(istft_sharded(spec, window, STEP, mesh))
    assert out.shape == ref.shape
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(out, ref, atol=1e-12 * max(1.0, scale))
    assert snr_db(signal[: len(out)], out) > 250.0


def test_cqt_tp_2d_mesh(signal):
    """TP CQT on the 2-D batch x frames mesh with a batched signal — the
    CLAUDE.md sharded-op test matrix's 2-D row for cqtspectrogram_tp."""
    import jax

    from zaftpu.sharding import cqtspectrogram_tp, make_mesh_2d

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh2 = make_mesh_2d(2, 2)
    kern = zaftpu.cqtkernel(44100, 24, 55, 3520)
    x32 = signal.astype(np.float32)
    batch = np.stack([x32, np.roll(x32, 4321)])
    ref = np.stack([np.asarray(zaftpu.cqtspectrogram(b, 44100, 25, kern))
                    for b in batch])
    out = np.asarray(cqtspectrogram_tp(batch, 44100, 25, kern, mesh2))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)
