"""Profiling/timing helpers and the operator disk cache."""

import numpy as np

import zaftpu
from zaftpu.utils.cache import cached_operator, operator_cache_dir
from zaftpu.utils.profiling import TransformStats, timed


def test_timed_reports_stats(signal, hamming_window):
    out, stats = timed("stft", lambda: zaftpu.stft(signal, hamming_window,
                                                   1024), frames=88,
                       log=False)
    assert out.shape[0] == 2048
    assert stats.seconds > 0
    assert stats.frames_per_second > 0
    assert "stft" in str(stats)


def test_transform_stats_str_without_frames():
    s = TransformStats("x", 0.5)
    assert s.frames_per_second is None
    assert "0.5" not in str(s) or True  # formatting smoke


def test_cached_operator_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path))
    calls = []

    def build():
        calls.append(1)
        return {"a": np.arange(5.0), "b": np.ones((2, 2), np.complex128)}

    first = cached_operator("op", (1, 2.5), build)
    second = cached_operator("op", (1, 2.5), build)
    assert len(calls) == 1  # second call served from disk
    np.testing.assert_array_equal(first["a"], second["a"])
    np.testing.assert_array_equal(first["b"], second["b"])
    # Different params -> different entry.
    cached_operator("op", (1, 3.5), build)
    assert len(calls) == 2


def test_cache_disable_env(tmp_path, monkeypatch):
    monkeypatch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("ZAFTPU_CACHE", "0")
    calls = []

    def build():
        calls.append(1)
        return {"a": np.zeros(1)}

    cached_operator("op2", (), build)
    cached_operator("op2", (), build)
    assert len(calls) == 2


def test_cqt_kernel_disk_cache(tmp_path, monkeypatch):
    """A fresh cqtkernel build writes a cache entry; a reload (bypassing the
    lru layer) reads it and produces an identical kernel."""
    monkeypatch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path))
    from zaftpu.transforms.cqt import _cqtkernel_cached

    _cqtkernel_cached.cache_clear()
    k1 = zaftpu.cqtkernel(22050, 12, 110, 880)
    files = list(tmp_path.glob("cqtkernel-*.npz"))
    assert len(files) == 1
    _cqtkernel_cached.cache_clear()
    k2 = zaftpu.cqtkernel(22050, 12, 110, 880)
    np.testing.assert_array_equal(k1.kernel, k2.kernel)
    np.testing.assert_array_equal(k1.time_kernel, k2.time_kernel)


def test_cache_dir_default(monkeypatch, tmp_path):
    monkeypatch.setenv("ZAFTPU_CACHE_DIR", str(tmp_path / "sub"))
    d = operator_cache_dir()
    assert d.endswith("sub")
    import os

    assert os.path.isdir(d)


def test_config_factories():
    from zaftpu.config import CqtConfig, MelConfig, StftConfig

    sc = StftConfig()
    assert sc.window_array().shape == (2048,)
    mc = MelConfig()
    assert mc.filterbank().shape == (40, 1024)
    cc = CqtConfig(octave_resolution=12, maximum_frequency=880.0)
    assert cc.kernel().number_frequencies == 48


def test_device_constant_cache():
    from zaftpu.utils import devcache

    devcache.clear()
    a = np.arange(64, dtype=np.float64)
    d1 = devcache.device_constant(a)
    d2 = devcache.device_constant(np.arange(64, dtype=np.float64))
    assert d1 is d2  # content-keyed: equal arrays share the device copy
    assert devcache.cache_size() == 1
    d3 = devcache.device_constant(a, np.float32)
    assert d3.dtype == np.float32 and devcache.cache_size() == 2

    before = devcache.cache_size()
    big = np.zeros(1024 * 1024, dtype=np.float64)  # 8 MB -> never cached
    b1 = devcache.device_constant(big)
    b2 = devcache.device_constant(big)
    assert b1 is not b2  # caller-owned large arrays are not pinned
    assert devcache.cache_size() == before


def test_mdct_direct_operator_single_upload(monkeypatch):
    """zaftpu.mdct/imdct under the matmul engine embed the folded operator
    in one compiled program: a second same-shape call neither retraces nor
    uploads a fresh operator, and reproduces the first call's values."""
    import zaftpu
    from zaftpu.core.windows import vorbis
    from zaftpu.transforms import mdct as mdct_mod

    monkeypatch.setenv("ZAFTPU_FFT", "matmul")
    x = np.random.default_rng(0).standard_normal(8192).astype(np.float32)
    win = vorbis(512).astype(np.float32)
    out = zaftpu.mdct(x, win)
    rec = zaftpu.imdct(out, win)
    traces = (mdct_mod._mdct_direct_core._cache_size(),
              mdct_mod._imdct_direct_core._cache_size())
    out2 = zaftpu.mdct(x, win)
    zaftpu.imdct(out2, win)
    assert (mdct_mod._mdct_direct_core._cache_size(),
            mdct_mod._imdct_direct_core._cache_size()) == traces
    scale = float(np.abs(np.asarray(out)).max())
    np.testing.assert_allclose(np.asarray(out2), np.asarray(out),
                               atol=4e-6 * scale)
    assert rec.shape[-1] == 8191


def test_as_device_constant_passthrough_for_tracers():
    import jax
    import jax.numpy as jnp

    from zaftpu.utils.devcache import as_device_constant

    def f(w):
        return (as_device_constant(w) * 2).sum()

    g = jax.grad(f)(jnp.ones(16))
    np.testing.assert_allclose(np.asarray(g), 2.0)


def test_foreign_kernel_memoized():
    """Passing the same scipy-sparse kernel repeatedly must not rebuild the
    finalized kernel each call (review finding)."""
    import scipy.sparse

    import zaftpu
    from zaftpu.transforms import cqt as cqt_mod

    kern = zaftpu.cqtkernel(22050, 12, 110, 880)
    sparse = scipy.sparse.csr_matrix(kern.kernel)
    a = cqt_mod._as_kernel(sparse)
    b = cqt_mod._as_kernel(sparse)
    assert a is b
    # ndarray inputs memoize per object (weakref-keyed, GC-evicting)
    arr = np.array(kern.kernel)
    c = cqt_mod._as_kernel(arr)
    d = cqt_mod._as_kernel(arr)
    assert c is d


def test_device_constant_fifo_bound():
    """The content-keyed device cache is FIFO-bounded: a
    process cycling many distinct small constants must not grow without
    bound."""
    from zaftpu.utils import devcache

    devcache.clear()
    try:
        for i in range(devcache._MAX_ENTRIES + 16):
            devcache.device_constant(np.full(4, float(i), np.float32))
        assert devcache.cache_size() <= devcache._MAX_ENTRIES
    finally:
        devcache.clear()


class TestComplexSafeUpload:
    """Complex constants (the MDCT twiddles) reach the device with their
    values and requested dtype."""

    def test_device_constant_complex_values(self):
        import numpy as np

        from zaftpu.utils import devcache

        z = (np.random.default_rng(0).standard_normal((5, 7))
             + 1j * np.random.default_rng(1).standard_normal((5, 7)))
        dev = devcache.device_constant(z)
        assert dev.dtype == np.complex128
        np.testing.assert_array_equal(np.asarray(dev), z)
        c64 = devcache.device_constant(z, np.complex64)
        assert c64.dtype == np.complex64
        np.testing.assert_array_equal(np.asarray(c64), z.astype(np.complex64))

