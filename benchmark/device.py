"""The accelerator a run measures, its name and power limit, and where
JAX keeps its compiled programs.

A run measures the GPU and nothing else: with no GPU, or fewer than the
cell asks for, it fails before it prints a result.
"""

from __future__ import annotations

import os
import subprocess


class NoAcceleratorError(RuntimeError):
    """JAX found no GPU, or fewer than the cell needs."""


def enable_compile_cache(root: str) -> str:
    """Keep JAX's persistent compilation cache at ``<root>/.jax_cache``.

    The path is fixed (it is part of the cache's key) and lies inside the
    checkout, so only a cell's first run in a checkout compiles. Every
    program is cached, however quickly it compiled.
    """
    import jax

    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


def require_gpus(count: int):
    """The first ``count`` GPU devices; raises :class:`NoAcceleratorError`
    when JAX's default backend is not a GPU or has fewer devices."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise NoAcceleratorError(
            f"no GPU: JAX's default backend is {devices[0].platform!r}")
    if len(devices) < count:
        raise NoAcceleratorError(
            f"the cell needs {count} GPUs, JAX sees {len(devices)}")
    return devices[:count]


def card_info() -> str:
    """``name, power.limit`` of every card as ``nvidia-smi`` reports them,
    one entry per card. Raises when nvidia-smi cannot be read: no device
    time is reported without the card and its power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = [line.strip() for line in out.splitlines() if line.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi reported no card")
    return "; ".join(lines)


def device_record(devices) -> dict:
    """The devices as JAX reports them, in the result line's keys."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def memory_peak_bytes(devices) -> int | None:
    """Peak bytes in use on the fullest of ``devices`` (None where the
    backend keeps no statistics)."""
    peaks = []
    for dev in devices:
        stats = dev.memory_stats() or {}
        if "peak_bytes_in_use" in stats:
            peaks.append(int(stats["peak_bytes_in_use"]))
    return max(peaks) if peaks else None
