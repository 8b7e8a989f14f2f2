"""Device-resident cache for operator constants.

Transform wrappers receive host-side constants (windows, twiddle vectors,
filterbanks). Converting them with ``jnp.asarray`` on every call uploads
them to the device every call. :func:`device_constant` memoizes the device
copy of small arrays (< 2 MB), keyed by a content hash — safe even if the
caller mutates or rebuilds the host array. Large framework-owned operators
(the CQT kernel) are cached by the modules that own them.
"""

from __future__ import annotations

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
from jax._src import core as _core

_CONTENT_LIMIT = 2 * 1024 * 1024
_MAX_ENTRIES = 256  # FIFO-bounded: <=256 x <2MB caps device-side growth
_cache: dict = {}


def _tracing_active() -> bool:
    """Is a jit/grad/vmap trace active (a wrapper called from a user's
    transformation)? Caching a device value there would capture tracers."""
    return not _core.trace_state_clean()


def device_constant(array, dtype=None):
    """A cached on-device copy of ``array`` (optionally cast to ``dtype``).

    Only arrays under 2 MB are cached (content-keyed, so caller mutation or
    rebuilding is always safe); larger caller-owned arrays upload fresh each
    call. Inside an active trace (a transform wrapper called from a user's
    jit), caching would capture tracers — the array is embedded as a plain
    trace constant instead.
    """
    host = np.asarray(array)
    want = np.dtype(dtype) if dtype is not None else host.dtype
    host = host.astype(want) if want != host.dtype else host
    if _tracing_active() or host.nbytes >= _CONTENT_LIMIT:
        return jnp.asarray(host)
    key = (hashlib.md5(host.tobytes()).hexdigest(), host.shape,
           str(host.dtype))
    hit = _cache.get(key)
    if hit is not None:
        return hit
    dev = jnp.asarray(host)
    while len(_cache) >= _MAX_ENTRIES:
        # FIFO eviction (dict preserves insertion order): a long-lived
        # process cycling many distinct windows/filterbanks must not grow
        # host+device memory without bound.
        _cache.pop(next(iter(_cache)))
    _cache[key] = dev
    return dev


def as_device_constant(x, dtype=None):
    """:func:`device_constant` for host arrays; pass-through for jax arrays
    and tracers (so transforms stay differentiable w.r.t. windows)."""
    if isinstance(x, (jax.Array, jax.core.Tracer)):
        return x if dtype is None else x.astype(dtype)
    return device_constant(x, dtype)


def cache_size() -> int:
    return len(_cache)


def clear():
    _cache.clear()
