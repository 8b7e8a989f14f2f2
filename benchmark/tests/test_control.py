"""The control fails the comparison that the program passes (needs a GPU).

The control is the library's own lower-precision path: its DFT as GEMMs
and every matmul at XLA precision HIGH, one step below the HIGHEST that
the configurations state. At a size a test run holds (20-s segments, 30-s
clips), the program reads within every limit and the control reads over
at least one. On the CPU, where XLA gives every precision the same float32
products, there is nothing to see.
"""

from __future__ import annotations

import json
import os

import pytest

from benchmark import calibrate, run

from conftest import CELLS

SIZES = {"roundtrip.hour": {"segments": 2, "segment_seconds": 20},
         "cqt.hour": {"segments": 2, "segment_seconds": 20},
         "logmel.online": {"clips": 4, "clip_seconds": 30}}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(tiny_root, cell,
                                                    monkeypatch):
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("the control differs from the program only on a GPU")
    spec = run.Cell(tiny_root, cell)
    if len(jax.devices()) < spec.chips:
        pytest.skip(f"{cell} needs {spec.chips} GPUs")
    path = spec.path("traffic", spec.workload["traffic"] + ".json")
    traffic = run.load_json(path)
    traffic["input"] = SIZES[spec.workload["traffic"]]
    with open(path, "w") as fh:
        json.dump(traffic, fh)
    spec = run.Cell(tiny_root, cell)
    devices = jax.devices()[:spec.chips]

    program = calibrate.readings(spec, 11, 1.0, devices)["numbers"]
    for key, value in calibrate.CONTROL_ENV.items():
        monkeypatch.setenv(key, value)
    control = calibrate.readings(spec, 11, 1.0, devices)["numbers"]
    for key in calibrate.CONTROL_ENV:
        monkeypatch.delenv(key)

    assert all(program[k] <= lim for k, lim in spec.limits.items()), program
    assert any(control[k] > lim for k, lim in spec.limits.items()), control
    assert os.environ.get("ZAFTPU_PRECISION") is None
