"""Mean time, in microseconds, of the benchmark's ``submit`` span: the
public call from entry to return (validation, device constants, dispatch,
the host-to-device copy it starts), on the profiler's clock."""


def read(ctx):
    spans = ctx.spans("submit")
    if not spans:
        return None
    return sum(s.dur_ns for s in spans) / len(spans) * 1e-3
