"""From a profiler trace to numbers: busy time, idle share, time per layer,
and the breakdown of where the device's time went.

The trace is the ``.xplane.pb`` file that ``jax.profiler`` writes. Device
planes (``/device:GPU:<n>``) hold one line per CUDA stream with an event per
kernel, copy or memset. The host plane holds the benchmark's own spans
(:data:`SPANS`), on the same clock.

Layers are data: ``benchmark/layers/<layer>.json`` holds an ``order`` and a
list of regular expressions. An event belongs to the first layer, in
ascending ``order``, one of whose expressions matches its kernel name or
the XLA operation and op name in its stats (where ``jax.named_scope``
names appear); an event that none matches is ``other``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re

#: The benchmark's host spans: the measured window, and inside it the call
#: that submits one request and the wait for the oldest request in flight.
SPANS = ("window", "submit", "wait")
DEVICE_PLANE = re.compile(r"^/device:GPU:(\d+)$")
OP_STATS = ("hlo_op", "tf_op")
NAME_CHARS = 120


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    start_ns: float
    dur_ns: float
    op: str = ""

    @property
    def end_ns(self) -> float:
        return self.start_ns + self.dur_ns


@dataclasses.dataclass
class Trace:
    """Device events per device ordinal, and the benchmark's host spans."""

    devices: dict
    spans: list
    window_s: float | None = None

    def window(self):
        """``(start_ns, end_ns)`` of the measured window: from the start of
        the ``window`` span, ``window_s`` long where that is given (the
        span itself stays open while the last requests drain)."""
        marks = [s for s in self.spans if s.name == "window"]
        if not marks:
            raise ValueError("the trace holds no 'window' span")
        start = marks[0].start_ns
        if self.window_s is None:
            return start, marks[0].end_ns
        return start, start + self.window_s * 1e9

    def spans_named(self, name: str):
        return [s for s in self.spans if s.name == name]

    def in_window(self, device: int):
        """The device's events clipped to the window."""
        lo, hi = self.window()
        out = []
        for ev in self.devices.get(device, ()):
            a, b = max(ev.start_ns, lo), min(ev.end_ns, hi)
            if b > a:
                out.append(Event(ev.name, a, b - a, ev.op))
        return out


def find_xspace(log_dir: str) -> str:
    """The one ``.xplane.pb`` file under a profiler log directory."""
    found = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if len(found) != 1:
        raise FileNotFoundError(
            f"expected one .xplane.pb under {log_dir}, found {len(found)}")
    return found[0]


def _op_of(event) -> str:
    """The XLA operation an event ran for and its op name, from its
    stats."""
    stats = dict(event.stats)
    return " ".join(stats[k] for k in OP_STATS
                    if isinstance(stats.get(k), str))


def load(path: str, window_s: float | None = None) -> Trace:
    """Read a ``.xplane.pb`` file into device events and host spans; the
    window is ``window_s`` long from the start of its span."""
    from jax.profiler import ProfileData

    with open(path, "rb") as fh:
        data = ProfileData.from_serialized_xspace(fh.read())
    devices, spans = {}, []
    for plane in data.planes:
        match = DEVICE_PLANE.match(plane.name)
        if match:
            events = devices.setdefault(int(match.group(1)), [])
            for line in plane.lines:
                events.extend(Event(e.name, e.start_ns, e.duration_ns,
                                    _op_of(e)) for e in line.events)
        elif plane.name.startswith("/host:"):
            for line in plane.lines:
                spans.extend(Event(e.name, e.start_ns, e.duration_ns)
                             for e in line.events if e.name in SPANS)
    for events in devices.values():
        events.sort(key=lambda e: e.start_ns)
    spans.sort(key=lambda e: e.start_ns)
    return Trace(devices, spans, window_s)


def union_intervals(events):
    """Merged ``[(start, end)]`` of the events' intervals, in order."""
    merged = []
    for ev in sorted(events, key=lambda e: e.start_ns):
        if merged and ev.start_ns <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], ev.end_ns)
        else:
            merged.append([ev.start_ns, ev.end_ns])
    return [tuple(m) for m in merged]


def busy_ns(events) -> float:
    """Length of the union of the events' intervals."""
    return sum(b - a for a, b in union_intervals(events))


def load_layers(layer_dir: str):
    """``[(name, [compiled patterns])]`` in ascending ``order`` from the
    ``<layer>.json`` files of a directory."""
    layers = []
    for path in sorted(glob.glob(os.path.join(layer_dir, "*.json"))):
        with open(path) as fh:
            spec = json.load(fh)
        name = os.path.basename(path)[:-len(".json")]
        layers.append((spec["order"], name,
                       [re.compile(p) for p in spec["patterns"]]))
    layers.sort(key=lambda t: (t[0], t[1]))
    return [(name, pats) for _, name, pats in layers]


def layer_of(event: Event, layers) -> str:
    for name, patterns in layers:
        if any(p.search(event.name) or (event.op and p.search(event.op))
               for p in patterns):
            return name
    return "other"


def short_name(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def top_ops(trace: Trace, count: int = 10):
    """``[[name, seconds]]``: the device operations that took most time in
    the window, summed over devices."""
    totals = {}
    for dev in trace.devices:
        for ev in trace.in_window(dev):
            key = short_name(ev.name)
            totals[key] = totals.get(key, 0.0) + ev.dur_ns
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:count]
    return [[name, ns * 1e-9] for name, ns in ranked]


def idle_gaps(trace: Trace, count: int = 10):
    """``[[label, seconds]]``: the longest stretches of the window in which
    a device ran nothing, each labelled with the benchmark span that was
    open on the host at its midpoint (``submit``, ``wait`` or ``none``)."""
    lo, hi = trace.window()
    inner = [s for s in trace.spans if s.name in ("submit", "wait")]
    gaps = []
    for dev in trace.devices:
        edge = lo
        for a, b in union_intervals(trace.in_window(dev)) + [(hi, hi)]:
            if a > edge:
                gaps.append((a - edge, (a + edge) / 2))
            edge = max(edge, b)
    gaps.sort(key=lambda g: -g[0])
    out = []
    for length, mid in gaps[:count]:
        label = "none"
        for span in inner:
            if span.start_ns <= mid <= span.end_ns:
                label = span.name
                break
        out.append([label, length * 1e-9])
    return out
