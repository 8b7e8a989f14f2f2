"""A closed loop with ``in_flight`` requests outstanding.

A new request is submitted as soon as fewer are in flight; the loop then
waits for the oldest. A request completes when its output is ready on the
device, as the host sees it, and counts only if that happens inside the
window. Requests still in flight when the window closes are waited for
and kept for the comparison, but not counted.
"""

from __future__ import annotations

import collections
import time
import traceback

from benchmark.loops import LoopResult, span


def run(submit, seconds: float, in_flight: int, keep=frozenset(),
        spans: bool = False) -> LoopResult:
    """Run ``submit(i)`` for i = 0, 1, ... with ``in_flight`` outstanding
    for ``seconds``; outputs of the requests in ``keep`` are kept."""
    import jax

    result = LoopResult(window_s=float(seconds))
    pending = collections.deque()
    with span(spans, "window"):
        start = time.perf_counter()
        end = start + seconds
        index = 0
        while True:
            while len(pending) < in_flight and time.perf_counter() < end:
                t0 = time.perf_counter()
                result.attempted += 1
                try:
                    with span(spans, "submit"):
                        out = submit(index)
                    pending.append((index, t0, out))
                except Exception:  # a request that fails is counted
                    result.failed += 1
                    result.errors.append(traceback.format_exc(limit=3))
                index += 1
            if not pending:
                break
            j, t0, out = pending.popleft()
            try:
                with span(spans, "wait"):
                    jax.block_until_ready(out)
            except Exception:
                result.failed += 1
                result.errors.append(traceback.format_exc(limit=3))
                continue
            done = time.perf_counter()
            if done <= end:
                result.completed += 1
                result.latencies_s.append(done - t0)
            if j in keep:
                result.kept[j] = out
    return result

