"""Compute-dtype policy: the bf16 operator-GEMM fast path.

The framework's dtype rule is "follow the input" (f64 = CPU oracle, f32 =
accelerator fast path). Accelerators additionally run bf16 matmuls with f32
accumulation far faster than f32 ones (on the H100 the bf16 tensor-core rate
is ~15x the f32 CUDA-core rate), and the framework's heaviest compute is
exactly matmuls against precomputed operators: the fused time-domain CQT
kernel (2 x (T, 32768) x (32768, 144) per workload — reference workload
zaf.py:627-633), the mel filterbank product (zaf.py:369-373), and the MFCC
DCT-II matrix (zaf.py:445). FFTs stay in f32/f64 (complex bf16 does not
exist) — this policy only lowers the *operands of operator matmuls* to bf16
while keeping accumulation and all activations in f32.

Usage::

    with zaftpu.compute_dtype("bfloat16"):
        spec = zaftpu.cqtspectrogram(x_f32, sr, 25, kernel)  # bf16 GEMMs

or process-wide with ``ZAFTPU_DTYPE=bfloat16``. Accuracy vs f32 is gated in
tests/test_bf16.py at documented SNR thresholds.
"""

from __future__ import annotations

import contextlib
import os

import jax
import jax.numpy as jnp

_STATE: dict = {"override": None}
_ALIASES = {"bfloat16": "bfloat16", "bf16": "bfloat16",
            "float32": None, "f32": None, "none": None}


def matmul_dtype():
    """Current operator-matmul operand dtype, or None to follow the input.

    Resolution order: active :func:`compute_dtype` context, then the
    ``ZAFTPU_DTYPE`` env var, else None.
    """
    if _STATE["override"] is not None:
        return jnp.bfloat16 if _STATE["override"] == "bfloat16" else None
    env = os.environ.get("ZAFTPU_DTYPE", "").lower()
    if env in ("bf16", "bfloat16"):
        return jnp.bfloat16
    return None


@contextlib.contextmanager
def compute_dtype(dtype):
    """Context manager selecting the operand dtype for operator matmuls.

    ``"bfloat16"``/``"bf16"`` enables the bf16 fast path; ``"float32"``/
    ``None`` restores input-following behavior (and overrides the env var
    within the context).
    """
    name = str(dtype).lower() if dtype is not None else "none"
    if name not in _ALIASES:
        raise ValueError(
            f"compute_dtype must be bfloat16/bf16 or float32/None, "
            f"got {dtype!r}")
    prev = _STATE["override"]
    _STATE["override"] = _ALIASES[name] or "float32-pin"
    try:
        yield
    finally:
        _STATE["override"] = prev


# Transforms the bf16 dial must NOT lower: their operator matmuls are a
# rounding error next to the rfft that feeds them (MFCC's DCT-II is
# (T, 40) @ (40, 40); the mel filterbank product is (T, 1024) @ (1024, 40)),
# so lowering buys ~nothing and costs real accuracy in the log domain
# (~36 dB MFCC SNR vs f32). The CQT's 32k-contraction operator GEMMs are the
# transform the dial is for and stay policy-controlled.
BF16_EXEMPT = frozenset({"mfcc", "melspectrogram"})


def operator_dtype(input_dtype, transform: str | None = None):
    """Dtype to store/upload a precomputed operator in, given the activation
    dtype: bf16 under the bf16 policy (f32 activations only — the f64 oracle
    path never lowers), else the activation dtype. ``transform`` names the
    consuming transform so the per-transform exemption table
    (:data:`BF16_EXEMPT`) can opt roofline-ineligible transforms out of the
    dial."""
    if transform in BF16_EXEMPT:
        return jnp.dtype(input_dtype)
    if matmul_dtype() is not None and jnp.dtype(input_dtype) == jnp.float32:
        return jnp.bfloat16
    return jnp.dtype(input_dtype)


def matmul_precision():
    """XLA precision for exact-path (non-bf16) operator matmuls.

    ``ZAFTPU_PRECISION``: ``highest`` (default — true f32 products),
    ``split4`` (manual 4-pass bf16 scheme, ~104 dB vs f64 — see
    :func:`real_matmul`; non-GEMM sites fall back to HIGHEST), ``high``, or
    ``default`` (the backend's own f32 matmul mode — TF32 on the GPU, about
    three decimal digits; only meaningful for A/B measurement).
    """
    env = os.environ.get("ZAFTPU_PRECISION", "highest").lower()
    table = {"default": jax.lax.Precision.DEFAULT,
             "high": jax.lax.Precision.HIGH,
             "highest": jax.lax.Precision.HIGHEST,
             # Sites that cannot run the manual scheme (complex-operand
             # stages, conv formulations) keep full accuracy instead.
             "split4": jax.lax.Precision.HIGHEST}
    if env not in table:
        raise ValueError(
            f"ZAFTPU_PRECISION must be default/high/highest/split4, "
            f"got {env!r}")
    return table[env]


def split4_enabled() -> bool:
    """True when ``ZAFTPU_PRECISION=split4`` selects the manual 4-pass
    bf16-split GEMM for real f32 operator matmuls."""
    return os.environ.get("ZAFTPU_PRECISION", "highest").lower() == "split4"


def bf16_dot(x, y):
    """``x @ y`` over bf16 operands with f32 accumulation and output.

    Off the CPU this is the native bf16 x bf16 -> f32 dot (tensor cores on
    the GPU). CPU XLA has no BF16 x BF16 -> F32 dot thunk (a shard_map
    program containing one fails to run), so there the bf16 -> f32 casts —
    which are exact — feed an f32 dot that computes the same products.
    """
    if jax.default_backend() == "cpu":
        return jnp.matmul(x.astype(jnp.float32), y.astype(jnp.float32),
                          preferred_element_type=jnp.float32)
    return jnp.matmul(x, y, preferred_element_type=jnp.float32)


def _split4_matmul(a, b):
    """``a @ b`` as four single-pass bf16 GEMMs with f32 accumulation.

    Each f32 operand splits exactly into a bf16 pair ``x = hi + lo + eps``
    (``hi = bf16(x)``, ``lo = bf16(x - hi)``, ``|eps| ~ 2^-17 |x|``); the
    product expands to four bf16 x bf16 terms, ALL kept — XLA's
    ``Precision.HIGH`` is the same idea but drops ``lo @ lo``, which caps it
    near 95 dB, just under the 96 dB 16-bit-audio gate. Keeping the fourth
    term leaves only the ``eps`` truncation: ~104 dB. Terms accumulate
    smallest-first in f32.
    """
    a, b = jnp.asarray(a), jnp.asarray(b)
    ah, al = _bf16_split(a)
    bh, bl = _bf16_split(b)
    return (((bf16_dot(al, bl) + bf16_dot(al, bh)) + bf16_dot(ah, bl))
            + bf16_dot(ah, bh))


def _bf16_split(x):
    """Exact bf16 pair ``(hi, lo)`` with ``x = hi + lo + eps``,
    ``|eps| ~ 2^-17 |x|``. Goes through ``lax.reduce_precision``: XLA may
    elide a plain f32->bf16->f32 cast round trip under its excess-precision
    rule, which would zero the lo terms and silently collapse the split
    scheme to one bf16 pass."""
    hf = jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=7)
    return hf.astype(jnp.bfloat16), (x - hf).astype(jnp.bfloat16)


def real_matmul(a, b, bandwidth_bound=False):
    """Real-operand exact-path GEMM honoring the precision dial.

    Under ``ZAFTPU_PRECISION=split4`` (f32 operands only — the f64 oracle
    path never lowers) runs :func:`_split4_matmul`; otherwise a plain matmul
    at :func:`matmul_precision`. ``bandwidth_bound=True`` marks GEMMs whose
    cost is memory traffic, not arithmetic (tiny output width, huge
    contraction — the CQT's hop-width slab GEMMs at F=144): for those the
    split's extra operand materialization only adds bytes, so the dial
    keeps HIGHEST.
    """
    # Narrow outputs are bandwidth-bound regardless of the caller's flag:
    # the split streams the wide activation from memory four times for a
    # GEMM at N < 256 (the CQT case is N=144; the mel filterbank is N=40,
    # the MFCC DCT N=20). The GEMMs split4 exists for are N >= 1024
    # (DFT/MDCT operators).
    if (split4_enabled() and not bandwidth_bound
            and b.shape[-1] >= 256
            and a.dtype == jnp.float32
            and jnp.dtype(b.dtype) == jnp.float32):
        return _split4_matmul(a, b)
    return jnp.matmul(a, b, preferred_element_type=a.dtype,
                      precision=matmul_precision())


def operator_matmul(a, b, bandwidth_bound=False):
    """``a @ b`` against a precomputed operator ``b`` under the dtype
    policy: a bf16 operator lowers ``a`` to bf16 (:func:`bf16_dot` — one
    bf16 GEMM, f32 accumulation); any other operator dtype is promoted to
    ``a``'s dtype and computed at :func:`matmul_precision` (or the split4
    scheme under that dial — ``bandwidth_bound=True`` opts a traffic-bound
    GEMM out, see :func:`real_matmul`).

    The explicit precision matters: without it XLA may run an f32 matmul in
    a reduced-precision mode (TF32 on the GPU keeps about three decimal
    digits), which would make the framework's "f32" operator matmuls
    silently low-accurate and the bf16/f32 A/B meaningless. So the dtype
    dial is honest: f64 = oracle, f32 = accurate fast path, bf16 = fastest
    GEMMs at documented SNR.
    """
    if b.dtype == jnp.bfloat16:
        acc = bf16_dot(a.astype(jnp.bfloat16), b)
        out = jnp.float32 if a.dtype == jnp.bfloat16 else a.dtype
        return acc.astype(out)
    if not jnp.issubdtype(a.dtype, jnp.complexfloating):
        return real_matmul(a, jnp.asarray(b).astype(a.dtype),
                           bandwidth_bound=bandwidth_bound)
    return jnp.matmul(a, b.astype(a.dtype), preferred_element_type=a.dtype,
                      precision=matmul_precision())
