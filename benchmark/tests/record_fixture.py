"""Record the small trace that the reduction's tests read.

    python3 benchmark/tests/record_fixture.py <out.xplane.pb>

On a GPU: three short closed loops under the profiler, each inside the
benchmark's own spans: stft then istft of a 2-s device-resident segment
(cuFFT and XLA fusions), the CQT of a 3-s segment (GEMMs) and the mel
spectrogram of a 1-s host clip (a host-to-device copy). The xplane file is
copied to the path given, and a summary of its planes, lines and event
names is printed.
"""

from __future__ import annotations

import collections
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

SECONDS = 0.05


def main(out: str) -> int:
    import jax
    from jax.profiler import ProfileData

    from benchmark import device, reduce, run
    from benchmark.loops import closed
    from benchmark.entries import cqtspectrogram, melspectrogram, stft_istft

    device.enable_compile_cache(ROOT)
    devices = device.require_gpus(1)
    zaf = run.load_json(os.path.join(ROOT, "benchmark/configs/zaf44k.json"))
    whisper = run.load_json(os.path.join(
        ROOT, "benchmark/configs/whisper16k.json"))
    seg = {"input": {"segments": 2, "segment_seconds": 2}}
    entries = [stft_istft.Entry(zaf, seg, 1, devices),
               cqtspectrogram.Entry(zaf, {"input": {"segments": 2,
                                                    "segment_seconds": 3}},
                                    2, devices),
               melspectrogram.Entry(whisper, {"input": {"clips": 2,
                                                        "clip_seconds": 1}},
                                    3, devices)]
    for entry in entries:
        for i in range(2):
            jax.block_until_ready(entry.submit(i))
    log_dir = tempfile.mkdtemp(prefix="bench-fixture-")
    jax.profiler.start_trace(log_dir, profiler_options=run.profiler_options())
    for entry in entries:
        closed.run(entry.submit, SECONDS, 2, spans=True)
    jax.profiler.stop_trace()
    path = reduce.find_xspace(log_dir)
    shutil.copy(path, out)
    shutil.rmtree(log_dir, ignore_errors=True)
    print(f"{out}: {os.path.getsize(out)} bytes")

    with open(out, "rb") as fh:
        data = ProfileData.from_serialized_xspace(fh.read())
    for plane in data.planes:
        lines = list(plane.lines)
        print(f"plane {plane.name!r}: {len(lines)} lines")
        for line in lines:
            names = collections.Counter(e.name for e in line.events)
            events = list(line.events)
            stats = sorted({k for e in events[:50] for k, _ in e.stats})
            first = events[0].start_ns if events else None
            print(f"  line {line.name!r}: {len(events)} events, first at "
                  f"{first}, stats {stats}")
            for name, count in names.most_common(12):
                print(f"    {count:5d} {name[:150]}")
    trace = reduce.load(out)
    layers = reduce.load_layers(os.path.join(ROOT, "benchmark/layers"))
    for dev, events in trace.devices.items():
        per = collections.Counter()
        for ev in events:
            per[reduce.layer_of(ev, layers)] += ev.dur_ns
        print(f"device {dev}: ns per layer {dict(per)}")
        other = collections.Counter(
            e.name[:100] for e in events
            if reduce.layer_of(e, layers) == "other")
        print(f"  unmatched: {other.most_common(10)}")
    print("spans", collections.Counter(s.name for s in trace.spans))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
