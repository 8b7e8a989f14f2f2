"""chip_smoke.py and bench.py off the card: the phases at a tiny size on the
CPU, the device requirements, and the compile-cache placement.

The phase functions are the ones the GPU run executes; here they run on the
CPU test backend at a few seconds of audio so their control flow and
comparisons are exercised without a card. Both scripts must exit non-zero
and print no result when JAX finds no GPU.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from zaftpu.bench import device as bench_device  # noqa: E402


@pytest.fixture()
def report(capsys):
    return chip_smoke.Report("cpu test backend")


def test_phase_parity_tiny(report, capsys):
    chip_smoke.phase_parity(report, seconds=2, rows=8)
    out = capsys.readouterr().out
    for name in ("stft", "istft", "cqtchromagram", "dst4", "griffin_lim"):
        assert f"] {name}" in out
    assert "FAILED" not in out


def test_phase_hour_tiny(report, capsys):
    chip_smoke.phase_hour(report, seconds=3)
    out = capsys.readouterr().out
    assert "stft->istft" in out and "mdct->imdct" in out


def test_phase_families_tiny(report, capsys):
    chip_smoke.phase_families(report, seconds=2, rows=8)
    out = capsys.readouterr().out
    assert "memory_analysis" in out and out.count("all finite") == 18


def test_phase_dials_tiny(report, capsys):
    before = {k: os.environ.get(k) for k in ("ZAFTPU_PRECISION",
                                             "ZAFTPU_FFT")}
    chip_smoke.phase_dials(report, seconds=2)
    out = capsys.readouterr().out
    assert "ZAFTPU_PRECISION=split4+ZAFTPU_FFT=matmul stft->istft" in out
    assert "bf16 cqtspectrogram" in out
    # the dials are restored afterwards
    assert {k: os.environ.get(k) for k in before} == before


def test_phase_sharded_one_tiny(report, capsys):
    chip_smoke.phase_sharded_one(report, seconds=2)
    assert capsys.readouterr().out.count("SNR dB vs plain") == 6


def test_phase_stream_tiny(report, capsys, tmp_path):
    work = tmp_path / "smoke"
    chip_smoke.phase_stream(report, seconds=2, workdir=str(work))
    assert "BlockReader->stft" in capsys.readouterr().out
    assert not work.exists()  # the WAV does not outlive the phase


def test_phase_four_tiny(report, capsys):
    devices = jax.devices()
    if len(devices) < 4:
        pytest.fail("the test backend provides 8 virtual CPU devices")
    chip_smoke.phase_four(report, seconds=4, batch_seconds=2,
                          devices=devices[:4])
    out = capsys.readouterr().out
    assert out.count("devices 4 >= 4 ok") == 9


@pytest.mark.parametrize("value,limit,at_most", [
    (float("nan"), 90.0, False), (89.9, 90.0, False), (1e-2, 5e-3, True)])
def test_report_check_raises_on_miss(value, limit, at_most, capsys):
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.Report("x").check("p", "n", 0.0, "q", value, limit,
                                     at_most=at_most)
    assert "FAILED" in capsys.readouterr().out


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_fails_without_gpu(script):
    proc = _run([script], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "metric" not in proc.stdout
    assert "NoAcceleratorError" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the package, the script fails and
    prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_require_gpu_on_cpu():
    with pytest.raises(bench_device.NoAcceleratorError):
        bench_device.require_gpu()


def test_device_record_keys():
    record = bench_device.device_record(jax.devices())
    assert set(record) == {"platform", "kind", "count"}
    assert record["platform"] == "cpu" and record["count"] == len(
        jax.devices())
    json.dumps(record)


def test_compile_cache_dir_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert bench_device.compile_cache_dir(REPO) is None
    assert bench_device.enable_compile_cache(REPO) is None


def test_compile_cache_dir_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert bench_device.compile_cache_dir(REPO) == os.path.join(
        REPO, ".jax_cache")


def test_enable_compile_cache_sets_config(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        path = bench_device.enable_compile_cache(str(tmp_path))
        assert path == os.path.join(str(tmp_path), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          before[1])


def test_seeded_signal_is_deterministic(monkeypatch):
    from zaftpu.bench import harness

    a = harness.seeded_signal(0.5, seed=3)
    np.testing.assert_array_equal(a, harness.seeded_signal(0.5, seed=3))
    assert a.dtype == np.float32 and a.shape == (22050,)
    assert not np.array_equal(a, harness.seeded_signal(0.5, seed=4))
    monkeypatch.setattr(harness, "SEGMENT_SECONDS", 1)
    parts = list(harness.segments(2.5))
    assert [len(p) for p in parts] == [44100, 44100, 22050]
    assert not np.array_equal(parts[0], parts[1])
