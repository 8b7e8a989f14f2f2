"""The benchmark's own tests: ``python -m pytest benchmark/tests``.

They run on the CPU (four virtual devices for the sharded cell) at tiny
sizes, in a copy of ``BENCHMARK.json`` and ``benchmark/`` whose traffic
files are shrunk. Tests marked ``gpu`` skip there; on a card run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu benchmark/tests``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import pytest  # noqa: E402

#: Tiny inputs per traffic mix, so a whole run takes seconds on the CPU.
TINY = {"roundtrip.hour": {"segments": 2, "segment_seconds": 2},
        "cqt.hour": {"segments": 2, "segment_seconds": 3},
        "logmel.online": {"clips": 3, "clip_seconds": 1},
        "roundtrip.12h": {"seconds": 4}}
CELLS = ("zaf44k.roundtrip.hour", "whisper16k.logmel.online",
         "zaf44k.cqt.hour")
#: The four-card cell that is not in BENCHMARK.json yet (its inverse runs
#: unsharded and does not fit at 12 h); its entry is exercised here.
SHARDED = "zaf44k.roundtrip.12h.4chip"
SEED = 3_000_000_007


def shrink(root: str) -> None:
    """Cut every traffic mix under ``root`` to its tiny inputs."""
    for name, inputs in TINY.items():
        path = os.path.join(root, "benchmark", "traffic", name + ".json")
        with open(path) as fh:
            traffic = json.load(fh)
        traffic["input"] = inputs
        traffic["warmup_requests"] = 2
        traffic["sample"] = {"requests": min(2, traffic["sample"]["requests"]),
                             "among_first": 3}
        with open(path, "w") as fh:
            json.dump(traffic, fh)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with tiny traffic, as a checkout root (the
    program linked in)."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    os.symlink(os.path.join(ROOT, "zaftpu"), os.path.join(tmp_path, "zaftpu"))
    shrink(str(tmp_path))
    return str(tmp_path)


@pytest.fixture
def sharded_root(tiny_root):
    """:func:`tiny_root` with the four-card cell added to its
    ``BENCHMARK.json``, and limits for it."""
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as fh:
        spec = json.load(fh)
    spec["workloads"].append({"name": SHARDED, "config": "zaf44k",
                              "traffic": "roundtrip.12h", "chips": 4,
                              "why": "test"})
    with open(path, "w") as fh:
        json.dump(spec, fh)
    with open(os.path.join(tiny_root, "benchmark", "limits",
                           SHARDED + ".json"), "w") as fh:
        json.dump({"spectrum_err": 3e-6, "signal_err": 1e-5}, fh)
    return tiny_root


def run_cell(root: str, cell: str, trace: int = 0, seed: int = SEED,
             seconds: float = 0.5) -> dict:
    """One run of the harness on the CPU; its last line, parsed."""
    from benchmark import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = run.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)],
                        root=root, accelerator=False)
    assert code == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
