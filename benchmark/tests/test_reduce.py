"""The trace reduction, on hand-made events and on a trace recorded on an
NVIDIA H100 (``fixtures/h100_trace.xplane.pb``, made by
``record_fixture.py``: three short closed loops, stft+istft of a 2-s
segment, the CQT of a 3-s segment and the mel spectrogram of a 1-s host
clip)."""

from __future__ import annotations

import dataclasses
import os

import pytest

from benchmark import reduce, run
from benchmark.entries import stft_istft
from benchmark.reduce import Event, Trace

from conftest import ROOT

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "h100_trace.xplane.pb")
LAYERS = os.path.join(ROOT, "benchmark", "layers")


def ev(name, start, dur, op=""):
    return Event(name, float(start), float(dur), op)


def test_union_merges_overlapping_nested_and_touching_intervals():
    events = [ev("a", 0, 10), ev("b", 5, 10), ev("c", 6, 2), ev("d", 15, 5),
              ev("e", 30, 5)]
    assert reduce.union_intervals(events) == [(0.0, 20.0), (30.0, 35.0)]
    assert reduce.busy_ns(events) == 25.0


def test_events_are_clipped_to_the_window():
    trace = Trace({0: [ev("k", -5, 10), ev("k", 95, 10), ev("k", 200, 1)]},
                  [ev("window", 0, 500)], window_s=100e-9)
    clipped = trace.in_window(0)
    assert [(e.start_ns, e.dur_ns) for e in clipped] == [(0.0, 5.0),
                                                         (95.0, 5.0)]


def test_an_event_belongs_to_the_first_matching_layer_in_order():
    layers = reduce.load_layers(LAYERS)
    assert reduce.layer_of(ev("loop_transpose_fusion", 0, 1), layers) == \
        "frame"
    assert reduce.layer_of(ev("gemm_fusion_dot", 0, 1), layers) == "gemm"
    assert reduce.layer_of(ev("void vector_fft<2048u>", 0, 1), layers) == \
        "dft"
    assert reduce.layer_of(
        ev("void scal_kernel_val<float2, float2>(cublasScal...)", 0, 1),
        layers) == "dft"
    assert reduce.layer_of(ev("MemcpyH2D", 0, 1), layers) == "h2d"
    assert reduce.layer_of(ev("ncclDevKernel_SendRecv", 0, 1), layers) == \
        "collective"
    assert reduce.layer_of(ev("mystery", 0, 1, op="fusion.3"), layers) == \
        "frame"
    assert reduce.layer_of(ev("mystery", 0, 1), layers) == "other"


def test_idle_gaps_are_labelled_with_the_open_host_span():
    spans = [ev("window", 0, 100), ev("submit", 10, 20), ev("wait", 50, 40)]
    trace = Trace({0: [ev("k", 0, 10), ev("k", 35, 10), ev("k", 80, 5)]},
                  spans, window_s=100e-9)
    gaps = reduce.idle_gaps(trace)
    assert [g[0] for g in gaps] == ["wait", "submit", "none"]
    assert gaps[0][1] == pytest.approx(35e-9)
    assert gaps[1][1] == pytest.approx(25e-9)
    assert gaps[2][1] == pytest.approx(15e-9)


def test_top_ops_sum_by_name_and_rank():
    trace = Trace({0: [ev("a", 0, 3), ev("b", 3, 5), ev("a", 8, 4)],
                   1: [ev("a", 0, 1)]}, [ev("window", 0, 20)])
    assert reduce.top_ops(trace) == [["a", 8e-9], ["b", 5e-9]]


@pytest.fixture(scope="module")
def recorded():
    return reduce.load(FIXTURE)


def loop_traces(trace):
    """The fixture's three loops, each as a trace of its own window."""
    windows = trace.spans_named("window")
    out = []
    for w in windows:
        inner = [s for s in trace.spans
                 if w.start_ns <= s.start_ns <= w.end_ns]
        out.append(dataclasses.replace(trace, spans=inner))
    return out


def test_recorded_trace_has_device_events_and_the_benchmark_spans(recorded):
    assert list(recorded.devices) == [0]
    names = {s.name for s in recorded.spans}
    assert names == {"window", "submit", "wait"}
    assert len(recorded.spans_named("window")) == 3
    layers = reduce.load_layers(LAYERS)
    unmatched = [e.name for e in recorded.devices[0]
                 if reduce.layer_of(e, layers) == "other"]
    assert unmatched == []


def test_each_recorded_loop_shows_the_layers_it_exercises(recorded):
    layers = reduce.load_layers(LAYERS)
    roundtrip, cqt, mel = loop_traces(recorded)
    per = []
    for trace in (roundtrip, cqt, mel):
        events = trace.in_window(0)
        lo, hi = trace.window()
        busy = reduce.busy_ns(events)
        assert 0 < busy <= hi - lo
        per.append({name: sum(e.dur_ns for e in events
                              if reduce.layer_of(e, layers) == name)
                    for name in ("dft", "frame", "gemm", "h2d")})
        per[-1]["busy"] = busy
    assert per[0]["dft"] > 0 and per[0]["frame"] > 0 and per[0]["gemm"] == 0
    assert per[1]["gemm"] > 0.8 * per[1]["busy"]
    assert per[2]["h2d"] > 0 and per[2]["dft"] > 0


def test_breakdown_of_the_recorded_trace(recorded):
    for trace in loop_traces(recorded):
        ops = reduce.top_ops(trace)
        gaps = reduce.idle_gaps(trace)
        assert 0 < len(ops) <= 10 and len(gaps) <= 10
        assert [o[1] for o in ops] == sorted((o[1] for o in ops),
                                             reverse=True)
        assert all(len(o[0]) <= reduce.NAME_CHARS for o in ops)
        assert all(g[0] in ("submit", "wait", "none") for g in gaps)


class Result:
    window_s = 0.05
    completed = 10


def test_per_layer_readers_on_the_recorded_trace(recorded):
    """Each reader, on the loop that exercises its layer, reads a number
    within its range; on a loop without its layer it reads nothing."""
    layers = reduce.load_layers(LAYERS)
    peaks = run.load_json(os.path.join(
        ROOT, "benchmark", "peaks", "NVIDIA_H100_80GB_HBM3.json"))
    roundtrip, cqt, mel = loop_traces(recorded)
    zaf = run.load_json(os.path.join(ROOT, "benchmark", "configs",
                                     "zaf44k.json"))
    work = stft_istft.work(zaf, {"input": {"segment_seconds": 2}})

    def read(name, trace):
        reader = run.load_module(os.path.join(
            ROOT, "benchmark", "metrics", name + ".py"))
        result = Result()
        lo, hi = trace.window()
        result.window_s = (hi - lo) * 1e-9
        result.completed = sum(1 for s in trace.spans_named("wait")
                               if s.end_ns <= hi)
        ctx = run.LayerContext(trace, layers, result, 2.0, 1, work, peaks)
        return reader.read(ctx)

    assert 0 < read("request_roofline", roundtrip) <= 100
    assert 0 <= read("device_idle_pct.pass", roundtrip) < 100
    assert read("dft_us_per_audio_min.pass", roundtrip) > 0
    assert read("frame_us_per_audio_min.pass", roundtrip) > 0
    assert read("gemm_us_per_audio_min.cqt", cqt) > 0
    assert read("gemm_us_per_audio_min.cqt", roundtrip) is None
    assert read("host_call_us.online", mel) > 0
    assert read("h2d_us.online", mel) > 0
    assert read("h2d_us.online", roundtrip) is None
    assert read("collective_ms.4chip", roundtrip) is None
