"""Load generators. A traffic file names one by its ``loop`` key; the
harness loads ``benchmark/loops/<loop>.py`` and calls its ``run``.

What every loop returns (:class:`LoopResult`) and the benchmark's host
spans (:func:`span`) live here.
"""

from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class LoopResult:
    """Requests attempted, completed inside the window and failed; the
    latency of each completed one; the kept outputs by request index."""

    window_s: float
    attempted: int = 0
    completed: int = 0
    failed: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    kept: dict = dataclasses.field(default_factory=dict)
    errors: list = dataclasses.field(default_factory=list)


def span(on: bool, name: str):
    """The benchmark's host span ``name`` on the profiler's clock, when
    ``on``."""
    if not on:
        return contextlib.nullcontext()
    import jax

    return jax.profiler.TraceAnnotation(name)
