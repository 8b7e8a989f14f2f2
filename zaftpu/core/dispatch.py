"""Dispatch-coherent jit: trace caches keyed on the ZAFTPU flag snapshot.

Every transform's device program is shaped at *trace time* by the
``ZAFTPU_*`` environment flags (FFT engine selection, matmul precision) and
by the :func:`zaftpu.core.policy.compute_dtype` context. A bare ``jax.jit``
caches traces by shapes/statics only, so flipping a flag after a shape has
been seen would silently reuse the stale program — an A/B in a notebook
would report right numbers under wrong labels.

:func:`zjit` fixes this structurally: the wrapped function gains a
keyword-only ``_dispatch`` **static argument** and every call passes the
current :class:`zaftpu.config.DispatchConfig` snapshot. A flag flip changes
the static value, so the first call after the flip retraces with the new
dispatch; flipping *back* reuses the earlier still-warm trace — an A/B loop
pays two compiles total, not one per flip.

(The snapshot must be a true static argument: two ``jax.jit`` objects over
the same Python function share their underlying trace cache, so keying a
table of jit instances on the snapshot does NOT isolate traces.)
"""

from __future__ import annotations

import functools
import inspect

import jax

from zaftpu.config import DispatchConfig


def zjit(fn=None, *, static_argnames=()):
    """``jax.jit`` whose trace cache is additionally keyed on the current
    :class:`~zaftpu.config.DispatchConfig` snapshot.

    Drop-in for ``jax.jit``/``partial(jax.jit, static_argnames=...)`` at
    every jit boundary whose trace consults a ``ZAFTPU_*`` flag (directly or
    through :mod:`zaftpu.core.fft` / :mod:`zaftpu.core.policy`).
    """
    if fn is None:
        return functools.partial(zjit, static_argnames=static_argnames)

    def shim(*args, _dispatch=None, **kwargs):
        return fn(*args, **kwargs)

    # jax.jit resolves static_argnames against inspect.signature(fun); give
    # the shim the wrapped function's signature plus the keyword-only
    # ``_dispatch`` slot so positional statics (e.g. step_length) still bind.
    sig = inspect.signature(fn)
    shim.__signature__ = sig.replace(parameters=[
        *sig.parameters.values(),
        inspect.Parameter("_dispatch", inspect.Parameter.KEYWORD_ONLY,
                          default=None),
    ])
    shim.__name__ = getattr(fn, "__name__", "zjit_fn")
    jitted = jax.jit(shim, static_argnames=tuple(static_argnames)
                     + ("_dispatch",))

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return jitted(*args, _dispatch=DispatchConfig.current(), **kwargs)

    wrapper._zjit = jitted            # test/introspection hooks
    wrapper._cache_size = jitted._cache_size
    return wrapper
