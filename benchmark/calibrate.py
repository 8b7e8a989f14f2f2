"""Readings that the limits of ``benchmark/limits/<cell>.json`` are set
from: the numbers compared, for the program on many seeds and for the
control on a few, all in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 7,8,9 --seconds 2

Each seed makes its inputs, warms up, drives the cell's own entry at the
cell's own load for a short window, and compares the kept outputs with the
float64 reference, exactly as a run does. The control is the library's own
lower-precision path switched on: its DFT as GEMMs (``ZAFTPU_FFT=matmul``)
and every matmul at XLA precision HIGH (``ZAFTPU_PRECISION=high``), one
step below the HIGHEST that the configurations state. One JSON line per
seed, then a summary: per number, the largest program reading, the
smallest control reading and the limit in force.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONTROL_ENV = {"ZAFTPU_FFT": "matmul", "ZAFTPU_PRECISION": "high"}


def readings(cell, seed: int, seconds: float, devices) -> dict:
    """One seed's numbers, as a run of the cell would compare them."""
    import jax

    from benchmark import run

    module = cell.entry_module()
    traffic = cell.traffic
    entry = module.Entry(cell.config, traffic, seed, devices)
    run.warm_up(entry, traffic)
    loop = run.load_module(cell.path("loops", traffic["loop"] + ".py")).run
    result = loop(entry.submit, seconds, int(traffic["in_flight"]),
                  keep=run.sample(seed, traffic["sample"]))
    with jax.enable_x64(True):
        numbers = entry.check(result.kept)
    out = {"numbers": numbers, "compared": len(result.kept),
           "completed": result.completed, "failed": result.failed}
    del entry, result
    gc.collect()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)

    from benchmark import device, run

    cell = run.Cell(ROOT, args.workload)
    device.enable_compile_cache(ROOT)
    devices = device.require_gpus(cell.chips)
    print(json.dumps({"card": device.card_info(),
                      "device": device.device_record(devices)}), flush=True)
    seen = {"program": {}, "control": {}}
    plans = [("program", args.seeds), ("control", args.control_seeds)]
    for mode, seeds in plans:
        for seed in [int(s) for s in seeds.split(",") if s]:
            if mode == "control":
                os.environ.update(CONTROL_ENV)
            try:
                got = readings(cell, seed, args.seconds, devices)
            except Exception as exc:  # a control that crashes has failed
                got = {"error": f"{type(exc).__name__}: {exc}"}
            finally:
                for key in CONTROL_ENV:
                    os.environ.pop(key, None)
            print(json.dumps({"mode": mode, "seed": seed, **got}),
                  flush=True)
            for name, value in got.get("numbers", {}).items():
                seen[mode].setdefault(name, []).append(value)
    summary = {}
    for name, limit in cell.limits.items():
        prog = seen["program"].get(name, [])
        ctrl = seen["control"].get(name, [])
        summary[name] = {"program_max": max(prog) if prog else None,
                         "control_min": min(ctrl) if ctrl else None,
                         "limit": limit}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
