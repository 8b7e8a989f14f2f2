"""The whole run, on the CPU at tiny sizes: every cell runs and compares
correct; a planted fault in the timed path makes ``correct`` false; a new
configuration, cell, traffic mix, loop, entry and per-layer metric are
taken up from new files alone; with no accelerator there is no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from benchmark import device, run

from conftest import CELLS, ROOT, SHARDED, run_cell


def bench_spec():
    return run.load_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_and_compares_correct(tiny_root, cell):
    line = run_cell(tiny_root, cell)
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] > 0
    wanted = {m["name"] for m in bench_spec()["end_to_end"]
              if run.applies(m, cell)}
    assert set(line["metrics"]) == wanted
    assert all(m["value"] > 0 for m in line["metrics"].values())
    limits = run.load_json(os.path.join(ROOT, "benchmark", "limits",
                                        cell + ".json"))
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(limits)
    for name, check in line["checks"].items():
        assert check["limit"] == limits[name]
        assert 0 <= check["value"] <= check["limit"]


def test_the_four_device_entry_runs_and_compares_correct(sharded_root):
    line = run_cell(sharded_root, SHARDED)
    assert line["correct"] is True
    assert line["device"]["count"] == 4
    assert set(line["checks"]) == {"spectrum_err", "signal_err"}


def test_a_traced_run_reports_the_window_and_a_breakdown(tiny_root):
    line = run_cell(tiny_root, "zaf44k.roundtrip.hour", trace=1)
    assert line["correct"] is True
    assert line["device"]["window_s"] == pytest.approx(0.5)
    assert "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def altered(fn):
    """``fn`` with one value of its output moved by 1 % of the output's
    largest magnitude: a wrong answer where it is produced."""
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        index = tuple(min(3, s - 1) for s in out.shape)
        return out.at[index].add(0.01 * jnp.max(jnp.abs(out)))
    return wrapper


#: Where each cell's answers are produced in the library.
PRODUCERS = {
    "zaf44k.roundtrip.hour": [("zaftpu.transforms.stft", "_stft_full"),
                              ("zaftpu.transforms.stft", "_istft_core")],
    "whisper16k.logmel.online": [("zaftpu.features.mel",
                                  "_melspectrogram_core")],
    "zaf44k.cqt.hour": [("zaftpu.transforms.cqt", "_cqt_apply_matmul")],
    SHARDED: [("zaftpu.sharding.sharded", "_stft_fused"),
              ("zaftpu.sharding.sharded", "_istft_core_sharded")],
}
FAULTS = [(cell, module, name) for cell, sites in PRODUCERS.items()
          for module, name in sites]


@pytest.fixture
def fresh_programs():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("cell,module,name", FAULTS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(
        sharded_root, monkeypatch, fresh_programs, cell, module, name):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, altered(getattr(mod, name)))
    line = run_cell(sharded_root, cell)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_the_exchange_between_chips_left_out_is_not_correct(
        sharded_root, monkeypatch, fresh_programs):
    from zaftpu.sharding import halo

    def no_pull(block, size, axis_name):
        return jnp.concatenate(
            [block, jnp.zeros(block.shape[:-1] + (size,), block.dtype)], -1)

    monkeypatch.setattr(halo, "pull_from_right", no_pull)
    monkeypatch.setattr(halo, "push_right_sum",
                        lambda body, tail, axis_name: body)
    line = run_cell(sharded_root, SHARDED)
    assert line["correct"] is False
    assert line["checks"]["spectrum_err"]["value"] > \
        line["checks"]["spectrum_err"]["limit"]


NEW_ENTRY = '''
import numpy as np
from benchmark import reference, signals


def work(cfg, traffic):
    return {"bytes": 1, "flops": 1}


class Entry:
    def __init__(self, cfg, traffic, seed, devices):
        import zaftpu
        self._zaftpu = zaftpu
        sr = cfg["sampling_frequency"]
        n = int(traffic["input"]["segment_seconds"] * sr)
        self.step = cfg["stft"]["step_length"]
        self.window = reference.window(cfg["stft"])
        mix = signals.ToneMix.from_seed(seed, sr)
        self.inputs = signals.device_pieces(mix, 1, n)
        self.audio_s = n / sr

    def submit(self, i):
        return self._zaftpu.spectrogram(self.inputs[0],
                                        self.window.astype(np.float32),
                                        self.step)

    def check(self, kept):
        worst = 0.0
        for out in kept.values():
            x = np.asarray(self.inputs[0], np.float64)
            wl = self.window.shape[0]
            pad = wl // 2
            t = out.shape[1]
            padded = np.zeros(t * self.step + wl)
            padded[pad:pad + x.shape[0]] = x
            idx = np.arange(t)[:, None] * self.step + np.arange(wl)
            ref = np.abs(np.fft.fft(padded[idx] * self.window))[:, 1:wl // 2 + 1].T
            worst = max(worst, float(np.max(np.abs(np.asarray(out) - ref))
                                     / np.max(ref)))
        return {"spectrogram_err": worst}
'''

NEW_LOOP = '''
from benchmark.loops import closed


def run(submit, seconds, in_flight, keep=frozenset(), spans=False):
    """One request at a time, whatever the traffic asks."""
    return closed.run(submit, seconds, 1, keep=keep, spans=spans)
'''

NEW_METRIC = '''
def read(ctx):
    spans = ctx.spans("submit")
    return float(len(spans)) if spans else None
'''


def test_a_new_cell_is_taken_up_from_new_files_alone(tiny_root):
    bench = os.path.join(tiny_root, "benchmark")

    def write(rel, text):
        with open(os.path.join(bench, rel), "w") as fh:
            fh.write(text)

    write("configs/zaf22k.json", json.dumps({
        "sampling_frequency": 22050,
        "stft": {"window": "hann", "periodic": True, "window_length": 1024,
                 "step_length": 256}}))
    write("traffic/spectrogram.tiny.json", json.dumps({
        "entry": "spectrogram_test", "loop": "serial_test", "in_flight": 3,
        "input": {"segment_seconds": 1},
        "sample": {"requests": 1, "among_first": 2}}))
    write("entries/spectrogram_test.py", NEW_ENTRY)
    write("loops/serial_test.py", NEW_LOOP)
    write("metrics/submit_spans.test.py", NEW_METRIC)
    write("limits/zaf22k.spectrogram.tiny.json",
          json.dumps({"spectrogram_err": 1e-5}))
    spec_path = os.path.join(tiny_root, "BENCHMARK.json")
    spec = run.load_json(spec_path)
    spec["configs"].append({"name": "zaf22k", "source": "test",
                            "file": "benchmark/configs/zaf22k.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "zaf22k.spectrogram.tiny",
                              "config": "zaf22k",
                              "traffic": "spectrogram.tiny", "chips": 1,
                              "why": "test"})
    for metric in spec["end_to_end"]:
        if metric["name"] == "audio_s_per_s":
            metric["workloads"].append("zaf22k.spectrogram.tiny")
    spec["per_layer"].append({"name": "submit_spans.test", "unit": "1",
                              "better": "lower", "source": "host_clock",
                              "layer": "test", "moves": "audio_s_per_s",
                              "workloads": ["zaf22k.spectrogram.tiny"]})
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)

    plain = run_cell(tiny_root, "zaf22k.spectrogram.tiny")
    assert plain["correct"] is True
    assert set(plain["metrics"]) == {"audio_s_per_s", "setup_s"}
    traced = run_cell(tiny_root, "zaf22k.spectrogram.tiny", trace=1)
    assert traced["correct"] is True
    assert traced["metrics"]["submit_spans.test"]["value"] >= 1


def test_with_no_accelerator_the_run_fails(tiny_root):
    with pytest.raises(device.NoAcceleratorError):
        run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
                 root=tiny_root)


def test_without_the_program_the_run_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and ``benchmark/``."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "zaftpu" in proc.stderr
