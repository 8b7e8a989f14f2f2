"""Device requirements shared by the benchmark and the chip smoke test.

Both scripts measure the accelerator and nothing else: with no GPU they
fail instead of falling back to the CPU, every result they print names the
device it ran on, and both keep JAX's persistent compilation cache at a
fixed path so a second run on the same machine reuses compiled programs.
The library itself never sets a cache directory.
"""

from __future__ import annotations

import os
import subprocess

import jax


class NoAcceleratorError(RuntimeError):
    """JAX found no GPU to measure."""


def compile_cache_dir(repo_root: str) -> str | None:
    """The directory to point JAX's compilation cache at: None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads that itself and no code
    may override it), else ``<repo_root>/.jax_cache`` — a fixed path, since
    the path is part of the cache key."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(os.path.abspath(repo_root), ".jax_cache")


def enable_compile_cache(repo_root: str) -> str | None:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir`; returns the directory set (None if the
    environment already chose one)."""
    path = compile_cache_dir(repo_root)
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def require_gpu():
    """The GPU devices JAX sees; raises :class:`NoAcceleratorError` when the
    default backend is not a GPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise NoAcceleratorError(
            f"no GPU: JAX's default backend is {devices[0].platform!r}")
    return devices


def card_info() -> str:
    """``name, power.limit`` of every card, as ``nvidia-smi`` reports them
    (one line per card). Raises when nvidia-smi cannot be read: a device
    time is not reported without the card and its power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = [line.strip() for line in out.splitlines() if line.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi reported no card")
    return "; ".join(lines)


def device_record(devices) -> dict:
    """The device as JAX reports it, in the benchmark's JSON keys."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}
