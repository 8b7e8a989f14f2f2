"""Run one cell of ``BENCHMARK.json`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (imports, the card's name and power limit, inputs made from the
seed, one warm-up pass over every shape the cell uses) is ``setup_s``.
Then the traffic's load generator drives the cell's entry for ``--seconds``
(``--trace 1``: a shorter window under the profiler). Once the window has
closed and the peak of device memory is read, the kept outputs are
compared with the float64 reference. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``,
each number compared beside its limit; the same numbers end standard
error.

Everything that belongs to one cell is found by name: the configuration's
file (``BENCHMARK.json``), ``benchmark/traffic/<traffic>.json`` (its
``entry`` and ``loop``), ``benchmark/entries/<entry>.py``,
``benchmark/loops/<loop>.py``,
``benchmark/limits/<cell>.json``, ``benchmark/end_to_end/<metric>.py``,
``benchmark/metrics/<metric>.py``, ``benchmark/layers/*.json`` and
``benchmark/peaks/<device kind>.json``.

With no GPU, or fewer than the cell asks for, the run fails and prints no
result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: Length of the traced window when the traffic file names none.
TRACE_SECONDS = 4.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str):
    """A module from its file, named after the file."""
    name = "bench_" + re.sub(r"\W", "_", os.path.relpath(path, ROOT))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def file_name(name: str) -> str:
    """A name as the harness's files spell it (letters, digits, ``_``,
    ``.`` and ``-``)."""
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of ``workloads`` with the files it names."""

    def __init__(self, root: str, name: str):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config = load_json(os.path.join(
            root, configs[self.workload["config"]]["file"]))
        self.traffic = load_json(self.path(
            "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(self.path("limits", name + ".json"))
        self.chips = int(self.workload["chips"])

    def path(self, *parts) -> str:
        return os.path.join(self.root, "benchmark", *parts)

    def entry_module(self):
        return load_module(self.path("entries",
                                     self.traffic["entry"] + ".py"))

    def metrics(self, kind: str):
        return [m for m in self.spec[kind] if applies(m, self.name)]


class Compiles:
    """Counts XLA compilations while ``counting`` is set."""

    def __init__(self):
        import jax

        self.counting = False
        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event: str, duration: float, **kwargs) -> None:
        if self.counting and "backend_compile" in event:
            self.count += 1


def sample(seed: int, spec: dict) -> frozenset:
    """Which requests' outputs are kept for the comparison, from the seed:
    ``requests`` of the first ``among_first``, the first request always
    among them."""
    import numpy as np

    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    among = int(spec["among_first"])
    count = min(int(spec["requests"]), among)
    rest = rng.choice(np.arange(1, among), size=count - 1, replace=False)
    return frozenset([0] + [int(i) for i in rest])


def warm_up(entry, traffic: dict) -> None:
    """Every shape the window uses, once, through the window's own calls
    (requests counted from 0, as the window's are)."""
    import jax

    count = int(traffic.get("warmup_requests", 2 * traffic["in_flight"]))
    for i in range(count):
        jax.block_until_ready(entry.submit(i))


def profiler_options():
    import jax

    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    opts.host_tracer_level = 1
    return opts


class RunRecord:
    """What the end-to-end readers see."""

    def __init__(self, setup_s, result, audio_s):
        self.setup_s = setup_s
        self.window_s = result.window_s
        self.completed = result.completed
        self.latencies_s = list(result.latencies_s)
        self.audio_s_per_request = audio_s


class LayerContext:
    """What the per-layer readers see: the reduced trace of the traced
    window, the layer table, the work of one request and the peaks."""

    def __init__(self, trace, layers, result, audio_s, chips, work, peaks):
        from benchmark import reduce

        self.trace = trace
        self.layers = layers
        self.window_s = result.window_s
        self.completed = result.completed
        self.audio_s = result.completed * audio_s
        self.chips = chips
        self.work = work
        self.peaks = peaks
        self.events = {d: trace.in_window(d) for d in trace.devices}
        self._reduce = reduce

    def busy_s(self) -> list:
        """Seconds in which each device ran an operation."""
        return [self._reduce.busy_ns(ev) * 1e-9
                for ev in self.events.values()]

    def idle_pct(self) -> float | None:
        """Share of the window in which the devices ran nothing, in
        percent (mean over the devices); None where nothing ran."""
        busy = self.busy_s()
        if not busy or not any(busy):
            return None
        return 100.0 * (1.0 - sum(busy) / len(busy) / self.window_s)

    def layer_s(self) -> dict:
        """Seconds of device time per layer, per device."""
        out = {}
        for dev, events in self.events.items():
            for ev in events:
                layer = self._reduce.layer_of(ev, self.layers)
                per = out.setdefault(layer, {})
                per[dev] = per.get(dev, 0.0) + ev.dur_ns * 1e-9
        return out

    def spans(self, name: str):
        lo, hi = self.trace.window()
        return [s for s in self.trace.spans_named(name)
                if lo <= s.start_ns < hi]


def program(root: str):
    """The system under test, ``zaftpu``, from the checkout at ``root``
    and nowhere else."""
    import zaftpu

    where = os.path.realpath(os.path.dirname(zaftpu.__file__))
    if where != os.path.realpath(os.path.join(root, "zaftpu")):
        raise ImportError(f"zaftpu comes from {where}, not from the "
                          f"checkout at {root}")
    return zaftpu


def peaks_for(cell: Cell, kind: str) -> dict:
    path = cell.path("peaks", file_name(kind) + ".json")
    if not os.path.exists(path):
        raise KeyError(f"device {kind!r} is not in the table of peaks "
                       f"({os.path.relpath(path, cell.root)})")
    return load_json(path)


def judge(numbers: dict, limits: dict, result, error: str | None):
    """``(correct, checks)``: every number at or under its limit, a
    comparison made, no request failed."""
    checks = {}
    ok = error is None and result.failed == 0 and bool(result.kept)
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks


def main(argv=None, root: str = ROOT, accelerator: bool = True) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = Cell(root, args.workload)

    import jax

    from benchmark import device, reduce

    device.enable_compile_cache(root)
    program(root)
    if accelerator:
        devices = device.require_gpus(cell.chips)
        card = device.card_info()
    else:
        devices = jax.devices()[:cell.chips]
        card = "no card (rehearsal)"
    log(f"[bench] {cell.name} seed {args.seed}: {device.device_record(devices)}"
        f"; nvidia-smi: {card}")

    traffic = cell.traffic
    module = cell.entry_module()
    entry = module.Entry(cell.config, traffic, args.seed, devices)
    warm_up(entry, traffic)
    keep = sample(args.seed, traffic["sample"])
    # What set-up left behind is never collected during the window.
    gc.collect()
    gc.freeze()
    loop = load_module(cell.path("loops", traffic["loop"] + ".py")).run
    compiles = Compiles()
    setup_s = time.perf_counter() - _T0
    log(f"[bench] setup {setup_s:.3f} s")

    seconds = args.seconds
    log_dir = None
    if args.trace:
        seconds = min(seconds, float(traffic.get("trace_seconds",
                                                 TRACE_SECONDS)))
        log_dir = tempfile.mkdtemp(prefix="bench-trace-")
        jax.profiler.start_trace(log_dir, profiler_options=profiler_options())
    compiles.counting = True
    try:
        result = loop(entry.submit, seconds, int(traffic["in_flight"]),
                      keep=keep, spans=bool(args.trace))
    finally:
        compiles.counting = False
        if args.trace:
            jax.profiler.stop_trace()
    log(f"[bench] window {result.window_s} s: {result.completed} requests "
        f"completed of {result.attempted}, {result.failed} failed, "
        f"{compiles.count} compiles inside the window")
    for err in result.errors[:3]:
        log(err)

    record = device.device_record(devices)
    record["memory_peak_bytes"] = device.memory_peak_bytes(devices)

    error = None
    numbers = {}
    started = time.perf_counter()
    try:
        with jax.enable_x64(True):
            numbers = entry.check(result.kept)
    except Exception as exc:  # a comparison that fails is not correct
        error = f"{type(exc).__name__}: {exc}"
        log(traceback.format_exc())
    correct, checks = judge(numbers, cell.limits, result, error)
    log(f"[bench] compared the outputs of requests {sorted(result.kept)} "
        f"in {time.perf_counter() - started:.3f} s")

    metrics = {}
    breakdown = None
    if args.trace:
        trace = reduce.load(reduce.find_xspace(log_dir), result.window_s)
        shutil.rmtree(log_dir, ignore_errors=True)
        layers = reduce.load_layers(cell.path("layers"))
        peaks = peaks_for(cell, record["kind"]) if accelerator else {}
        ctx = LayerContext(trace, layers, result, entry.audio_s, cell.chips,
                           module.work(cell.config, traffic), peaks)
        busy = ctx.busy_s()
        record["busy_s"] = sum(busy) / len(busy) if busy else 0.0
        record["window_s"] = result.window_s
        for spec in cell.metrics("per_layer"):
            reader = load_module(cell.path(
                "metrics", file_name(spec["name"]) + ".py"))
            value = reader.read(ctx)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
        breakdown = {"device_ops": reduce.top_ops(trace),
                     "idle_gaps": reduce.idle_gaps(trace)}
        if accelerator:
            from benchmark import probe

            print(json.dumps({"probe": probe.run(devices[0]),
                              "card": card}), flush=True)
    else:
        run = RunRecord(setup_s, result, entry.audio_s)
        for spec in cell.metrics("end_to_end"):
            reader = load_module(cell.path(
                "end_to_end", file_name(spec["name"]) + ".py"))
            value = reader.read(run)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}

    line = {"correct": correct, "attempted": result.attempted,
            "failed": result.failed, "metrics": metrics, "device": record}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for name, check in checks.items():
        log(f"[check] {name} {check['value']} limit {check['limit']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
