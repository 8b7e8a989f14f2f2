"""Observability: trace annotations, device timers, throughput counters.

The reference has no profiling hooks (SURVEY.md §5). Here every transform can
be wrapped in a ``jax.profiler`` trace annotation (visible in perfetto dumps
from ``jax.profiler.trace``), and :func:`timed` gives wall-clock device
timing with ``block_until_ready`` semantics plus frames/s — the framework's
headline metric (BASELINE.md).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time

import jax

logger = logging.getLogger("zaftpu")


@contextlib.contextmanager
def annotate(name: str):
    """Named trace region: shows up in profiler timelines and logs."""
    with jax.profiler.TraceAnnotation(name):
        yield


@dataclasses.dataclass
class TransformStats:
    """One timed transform execution."""

    name: str
    seconds: float
    frames: int | None = None

    @property
    def frames_per_second(self) -> float | None:
        if self.frames is None or self.seconds == 0:
            return None
        return self.frames / self.seconds

    def __str__(self) -> str:
        fps = self.frames_per_second
        extra = f", {fps:,.0f} frames/s" if fps else ""
        return f"{self.name}: {self.seconds * 1e3:.2f} ms{extra}"


def _block(x):
    """Wait until every device array in ``x`` (a pytree) is computed."""
    jax.block_until_ready(x)


def timed(name: str, fn, *args, frames: int | None = None, reps: int = 1,
          warmup: bool = True, log: bool = True):
    """Run ``fn(*args)`` on device, blocking, best-of-``reps`` timing.

    Each rep is one call ended by ``block_until_ready`` on the host clock
    (JAX dispatch is asynchronous, so a timing without it measures the
    enqueue). The warm-up call compiles and is not timed. Returns
    ``(result, TransformStats)``; logs at INFO when ``log``.
    """
    if warmup:
        _block(fn(*args))
    best = float("inf")
    result = None
    for _ in range(max(1, reps)):
        start = time.perf_counter()
        with annotate(name):
            result = fn(*args)
            _block(result)
        best = min(best, time.perf_counter() - start)
    stats = TransformStats(name=name, seconds=best, frames=frames)
    if log:
        logger.info("%s", stats)
    return result, stats
