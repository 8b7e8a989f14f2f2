"""Constant-Q transform: kernel, spectrogram, chromagram.

The CQT kernel is a parameter-only precompute; it is built once on host in
complex128 with construction math identical to the reference
(zaf.py:457-559: per-channel symmetric-Hamming-windowed complex exponentials
of nearest-odd length, centered in a ``fft_length`` buffer, FFT'd,
magnitude-thresholded at 0.01, conjugated and scaled by ``1/fft_length``) and
cached per parameter tuple.

Application is where this design departs from the reference. The reference
runs T sequential 32k-point FFTs each followed by a CSR matvec
(zaf.py:627-633). Here:

* frames are processed in fixed-size blocks under ``lax.map`` (bounded memory
  at any signal length — a naive batch of 1-hour frames would be ~12 GB);
* each block is one batched ``rfft`` (real input, half the FFT work);
* the thresholded kernel is dense but its nonzero *columns* are a small band
  (~4% of fft_length); only those columns are gathered from the spectrum and
  applied as a dense matmul, with Hermitian symmetry
  ``X[k] = conj(X[L-k])`` supplying any negative-frequency columns from the
  rfft half-spectrum;
* the float32 fast path goes further and removes the FFT entirely by folding
  it into the operator (GEMM-native NDFT — same idea as the MelT accelerator
  front-end, PAPERS.md): ``K @ FFT(x) == FFT(K-rows) @ x``, one real x
  complex matmul per frame block.
"""

from __future__ import annotations

import dataclasses
import os
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from zaftpu.core.dispatch import zjit
from zaftpu.core import policy as _policy
from zaftpu.core import windows as _windows


@dataclasses.dataclass(frozen=True)
class CqtKernel:
    """Precomputed CQT spectral kernel plus its reduced (banded) form.

    ``kernel`` matches ``reference cqtkernel(...).toarray()`` (zaf.py:457-559)
    bit-for-bit. ``columns_low``/``columns_high`` index its nonzero columns in
    the non-negative / negative frequency halves; ``reduced_low`` /
    ``reduced_high`` are the corresponding dense column blocks used on device.
    """

    kernel: np.ndarray            # (F, fft_length) complex128, thresholded
    columns_low: np.ndarray       # nonzero cols k <= L/2
    columns_high: np.ndarray      # nonzero cols k > L/2
    reduced_low: np.ndarray       # (F, len(columns_low)) complex128
    reduced_high: np.ndarray      # (F, len(columns_high)) complex128
    time_kernel: np.ndarray       # (F, fft_length) complex128, = FFT(kernel rows)

    @property
    def shape(self):
        return self.kernel.shape

    @property
    def number_frequencies(self) -> int:
        return self.kernel.shape[0]

    @property
    def fft_length(self) -> int:
        return self.kernel.shape[1]

    def toarray(self) -> np.ndarray:
        return self.kernel


@lru_cache(maxsize=8)
def _cqtkernel_cached(sampling_frequency: float, octave_resolution: int,
                      minimum_frequency: float,
                      maximum_frequency: float) -> CqtKernel:
    from zaftpu.utils.cache import cached_operator

    params = (sampling_frequency, octave_resolution, minimum_frequency,
              maximum_frequency)
    arrays = cached_operator(
        "cqtkernel", params,
        lambda: {"kernel": _build_cqt_kernel(*params)})
    return _finalize_kernel(arrays["kernel"])


def _build_cqt_kernel(sampling_frequency: float, octave_resolution: int,
                      minimum_frequency: float,
                      maximum_frequency: float) -> np.ndarray:
    # Constant quality factor Q = f_k / (f_{k+1} - f_k) (zaf.py:497).
    quality = 1.0 / (2.0 ** (1.0 / octave_resolution) - 1.0)
    number_frequencies = round(
        octave_resolution * np.log2(maximum_frequency / minimum_frequency))
    fft_length = int(2.0 ** np.ceil(
        np.log2(quality * sampling_frequency / minimum_frequency)))

    kernel = np.zeros((number_frequencies, fft_length), dtype=np.complex128)
    for i in range(number_frequencies):
        freq = minimum_frequency * 2.0 ** (i / octave_resolution)
        # Nearest odd length so the temporal kernel centers on 0 (zaf.py:521).
        length = 2 * round(quality * sampling_frequency / freq / 2) + 1
        offsets = np.arange(-(length - 1) / 2, (length - 1) / 2 + 1)
        temporal = (
            _windows.hamming(length, periodic=False)
            * np.exp(2j * np.pi * quality * offsets / length) / length
        )
        pad = (fft_length - length + 1) // 2
        kernel[i, pad:pad + length] = temporal

    kernel = np.fft.fft(kernel, axis=1)
    kernel[np.abs(kernel) < 0.01] = 0          # sparsity threshold zaf.py:551
    kernel = np.conj(kernel) / fft_length      # Parseval scaling zaf.py:557
    return kernel


def _finalize_kernel(kernel: np.ndarray) -> CqtKernel:
    fft_length = kernel.shape[1]
    nonzero_cols = np.nonzero(np.any(kernel != 0, axis=0))[0]
    half = fft_length // 2
    columns_low = nonzero_cols[nonzero_cols <= half]
    columns_high = nonzero_cols[nonzero_cols > half]
    # Fold the frame FFT into the operator: for any frame x,
    # (K @ FFT(x))[i] = sum_n x[n] * FFT(K[i, :])[n], so applying
    # FFT(kernel rows) directly to time-domain frames is mathematically
    # identical to the reference's per-frame FFT + sparse matvec
    # (zaf.py:627-633) — and turns the whole CQT into GEMMs over the
    # signal with no on-device 32768-point FFT.
    time_kernel = np.fft.fft(kernel, axis=1)
    return CqtKernel(
        kernel=kernel,
        columns_low=columns_low,
        columns_high=columns_high,
        reduced_low=np.ascontiguousarray(kernel[:, columns_low]),
        reduced_high=np.ascontiguousarray(kernel[:, columns_high]),
        time_kernel=time_kernel,
    )


def cqtkernel(sampling_frequency, octave_resolution, minimum_frequency,
              maximum_frequency) -> CqtKernel:
    """Constant-Q spectral kernel (reference zaf.py:457-559 semantics).

    Returns a :class:`CqtKernel`; ``.toarray()`` gives the dense
    ``(number_frequencies, fft_length)`` complex matrix identical to the
    reference's sparse kernel densified.
    """
    return _cqtkernel_cached(float(sampling_frequency),
                             int(octave_resolution),
                             float(minimum_frequency),
                             float(maximum_frequency))


_foreign_kernels: dict = {}
_FOREIGN_KERNEL_LIMIT = 8


def _as_kernel(cqt_kernel) -> CqtKernel:
    """Accept a CqtKernel, scipy sparse matrix, or dense array (parity).

    Foreign (non-CqtKernel) inputs require a ~1 s finalize (a 32k-point host
    FFT per row); results are memoized — by weak reference when the input
    supports it (scipy sparse), else by content hash — with FIFO eviction so
    repeated calls with the same user-owned kernel don't rebuild or pin
    memory without bound.
    """
    if isinstance(cqt_kernel, CqtKernel):
        return cqt_kernel
    import hashlib
    import weakref

    dense = np.asarray(cqt_kernel.toarray()
                       if hasattr(cqt_kernel, "toarray") else cqt_kernel)
    try:
        key = ("ref", id(cqt_kernel))
        hit = _foreign_kernels.get(key)
        if hit is not None and hit[0]() is cqt_kernel:
            return hit[1]
        finalized = _finalize_kernel(dense)
        # bind the dict as a default arg so interpreter-shutdown GC (module
        # globals already cleared) can't hit a None global
        ref = weakref.ref(
            cqt_kernel,
            lambda _, k=key, d=_foreign_kernels: d.pop(k, None))
        _foreign_kernels[key] = (ref, finalized)
    except TypeError:  # plain ndarrays aren't weak-referenceable
        key = ("content", hashlib.md5(dense.tobytes()).hexdigest())
        hit = _foreign_kernels.get(key)
        if hit is not None:
            return hit[1]
        finalized = _finalize_kernel(dense)
        _foreign_kernels[key] = (None, finalized)
    while len(_foreign_kernels) > _FOREIGN_KERNEL_LIMIT:
        _evict_kernel(next(iter(_foreign_kernels)))
    return finalized


def _evict_kernel(key):
    entry = _foreign_kernels.pop(key, None)
    if entry is not None:
        # Drop any device copies tied to the evicted kernel object.
        kern_id = id(entry[1])
        for dkey in [k for k in _device_kernels if k[0] == kern_id]:
            _device_kernels.pop(dkey, None)


def _block_frames() -> int:
    """Frames per on-device block: bounds the per-block buffers (the f64
    oracle's gathered frames are block * fft_length * 8 bytes). Larger
    blocks amortize per-block overhead and give the GEMMs taller M.
    ``ZAFTPU_CQT_BLOCK`` overrides; read per call, not at import (the block
    feeds a static jit argument)."""
    env = os.environ.get("ZAFTPU_CQT_BLOCK")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return 1024


@partial(zjit, static_argnames=("pads", "step_length", "fft_length",
                                   "number_times", "block_frames",
                                   "octave_resolution"))
def _cqt_apply(signal, k_reduced, gather_cols, conj_mask, pads, step_length,
               fft_length, number_times, block_frames, octave_resolution=0):
    """Blocked magnitude-CQT -> ``(F, T)`` (optionally octave-folded) in one
    jitted program; frames-major rfft internally.

    ``k_reduced`` holds only the kernel's nonzero columns; ``gather_cols``
    maps each of them into the rfft half-spectrum, with ``conj_mask`` marking
    negative-frequency columns supplied via Hermitian symmetry
    ``X[k] = conj(X[L-k])``. Leading batch axes are vmapped.
    """
    padded = _pad_last(signal, pads)

    def oracle_1d(padded_1d):
        blocks = -(-number_times // block_frames)
        starts = np.arange(block_frames) * step_length
        seg_len = (block_frames - 1) * step_length + fft_length

        def one_block(b):
            seg = jax.lax.dynamic_slice(
                padded_1d, (b * block_frames * step_length,), (seg_len,))
            frames = jax.vmap(lambda s: jax.lax.dynamic_slice(
                seg, (s,), (fft_length,)))(starts)
            half_spec = jnp.fft.rfft(frames, axis=-1)  # (B, L/2+1)
            gathered = half_spec[:, gather_cols]       # (B, C)
            gathered = jnp.where(conj_mask, jnp.conj(gathered), gathered)
            acc = jnp.matmul(gathered, k_reduced.T.astype(half_spec.dtype),
                             preferred_element_type=half_spec.dtype,
                             precision=jax.lax.Precision.HIGHEST)
            return jnp.abs(acc)                        # (B, F)

        out = jax.lax.map(one_block, jnp.arange(blocks))
        return out.reshape(blocks * block_frames, -1)[:number_times]

    spec = jnp.swapaxes(_batched_1d(oracle_1d)(padded), -1, -2)
    if octave_resolution:
        return _octave_fold(spec, octave_resolution)
    return spec


def _pad_last(x, pads):
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [tuple(pads)])


def _batched_1d(impl):
    """Lift a 1-D signal function over arbitrary leading batch axes."""
    def wrapper(padded, *args, **kwargs):
        if padded.ndim == 1:
            return impl(padded, *args, **kwargs)
        flat = padded.reshape(-1, padded.shape[-1])
        out = jax.vmap(lambda s: impl(s, *args, **kwargs))(flat)
        return out.reshape(padded.shape[:-1] + out.shape[1:])
    return wrapper


def _blocked_needed(total_frames: int, step_length: int,
                    fft_length: int) -> int:
    """Padded samples the blocked-matmul body reads: every slab slice spans
    ``block * step`` samples, so coverage rounds ``fft_length`` up to whole
    hops (``dynamic_slice`` would otherwise clamp at the buffer end and
    silently shift the last slab)."""
    n_slabs = -(-fft_length // step_length)
    return (total_frames - 1) * step_length + n_slabs * step_length


def _blocked_matmul_impl(padded, m_real, m_imag, step_length, fft_length,
                         number_times, block_frames):
    """Blocked fused time-domain CQT body (also reused inside shard_map).

    Frames are never materialized: the ``(fft_length, F)`` operator is
    decomposed into hop-width slabs ``M[k*step:(k+1)*step]`` and each block
    accumulates ``sum_k reshape(signal-slab_k) @ M_k`` where every signal
    slab is a *contiguous* ``(B, step)`` reshape of the padded signal —
    replacing the per-frame overlapped gather (the hop, 1764 at the
    defaults, is unaligned, and the gathered ``(B, fft_length)`` frame
    matrix is ~19x the signal's bytes)."""
    blocks = -(-number_times // block_frames)
    n_slabs = -(-fft_length // step_length)
    bs = block_frames * step_length

    def one_block(b):
        base = b * bs
        re = im = 0.0
        for k in range(n_slabs):
            lo = k * step_length
            width = min(step_length, fft_length - lo)
            slab = jax.lax.dynamic_slice(
                padded, (base + lo,), (bs,)).reshape(block_frames,
                                                     step_length)[:, :width]
            # bandwidth_bound: F=144 output columns over a K<=1764 slab is
            # traffic-bound — split4's operand splitting only adds bytes.
            re = re + _policy.operator_matmul(slab, m_real[lo:lo + width],
                                         bandwidth_bound=True)
            im = im + _policy.operator_matmul(slab, m_imag[lo:lo + width],
                                         bandwidth_bound=True)
        return jnp.sqrt(re * re + im * im)             # (B, F)

    out = jax.lax.map(one_block, jnp.arange(blocks))   # (blocks, B, F)
    return out.reshape(blocks * block_frames, -1)[:number_times]


@partial(zjit, static_argnames=("pads", "step_length", "fft_length",
                                   "number_times", "block_frames",
                                   "octave_resolution"))
def _cqt_apply_matmul(signal, m_real, m_imag, pads, step_length, fft_length,
                      number_times, block_frames, octave_resolution=0):
    """Fused time-domain CQT: frame blocks x FFT'd-kernel as two matmuls.

    ``m_real``/``m_imag`` are the real/imaginary parts of ``FFT(kernel rows)``
    transposed to ``(fft_length, F)``; no on-device FFT, no gather — the
    float32 fast path. Padding, transpose, and (optionally, when
    ``octave_resolution > 0``) the chromagram octave fold all run inside this
    one jitted program — a single device dispatch end to end. Leading batch
    axes are vmapped over the 1-D blocked body.
    """
    padded = _pad_last(signal, pads)
    out = _batched_1d(_blocked_matmul_impl)(
        padded, m_real, m_imag, step_length, fft_length, number_times,
        block_frames)
    spec = jnp.swapaxes(out, -1, -2)                    # (..., F, T)
    if octave_resolution:
        return _octave_fold(spec, octave_resolution)
    return spec


def _octave_fold(spec, octave_resolution):
    """chroma[i] = sum_k spec[..., i + k*OR, :] (reference zaf.py:693-698)."""
    *lead, f, t = spec.shape
    octaves = -(-f // octave_resolution)
    padded = jnp.pad(spec, [(0, 0)] * len(lead)
                     + [(0, octaves * octave_resolution - f), (0, 0)])
    return padded.reshape(*lead, octaves, octave_resolution, t).sum(axis=-3)


def _resolve_cqt_args(sampling_frequency, time_resolution, cqt_kernel,
                      config):
    """Resolve (sr, time_res, kernel) from positional args or a
    :class:`zaftpu.config.CqtConfig` (whose :meth:`kernel` is cached)."""
    if config is not None:
        if (sampling_frequency is not None or time_resolution is not None
                or cqt_kernel is not None):
            raise ValueError(
                "pass either (sampling_frequency, time_resolution, "
                "cqt_kernel) or config=, not both")
        return (config.sampling_frequency, config.time_resolution,
                config.kernel())
    if (sampling_frequency is None or time_resolution is None
            or cqt_kernel is None):
        raise ValueError(
            "sampling_frequency, time_resolution and cqt_kernel are "
            "required when no config= is given")
    return sampling_frequency, time_resolution, cqt_kernel


def cqtspectrogram(audio_signal, sampling_frequency=None,
                   time_resolution=None, cqt_kernel=None, *, config=None):
    """Magnitude CQT spectrogram ``(number_frequencies, number_times)``.

    Reference semantics (zaf.py:562-635): ``step = round(sr/time_res)``,
    ``T = floor(N/step)``, asymmetric centering pad, per-frame
    ``|K . fft(frame)|``. Accepts ``config=CqtConfig(...)`` in place of the
    three positional parameters.

    float32 fast path: the FFT folds into a time-domain operator applied as
    hop-width slab GEMMs at the precision dial's exact scheme (bf16 operands
    under ``compute_dtype("bfloat16")``); the f64 oracle path runs the
    reference's rfft + kernel product.
    """
    from zaftpu.core import validate as _validate

    sampling_frequency, time_resolution, cqt_kernel = _resolve_cqt_args(
        sampling_frequency, time_resolution, cqt_kernel, config)
    kern = _as_kernel(cqt_kernel)
    audio_signal = _validate.check_signal(jnp.asarray(audio_signal))
    step = round(float(sampling_frequency) / float(time_resolution))
    number_times = int(audio_signal.shape[-1] // step)
    if number_times < 1:
        raise ValueError(
            f"signal too short: {audio_signal.shape[-1]} samples is less "
            f"than one CQT hop ({step} samples at time_resolution="
            f"{time_resolution})")
    fft_length = kern.fft_length

    return _cqt_dispatch(audio_signal, kern, step, number_times, fft_length,
                         octave_resolution=0)


_device_kernels: dict = {}
_DEVICE_KERNEL_LIMIT = 16


def _bound_device_kernels():
    while len(_device_kernels) > _DEVICE_KERNEL_LIMIT:
        _device_kernels.pop(next(iter(_device_kernels)))


def _device_time_kernel(kern: CqtKernel, dtype):
    """Device-resident (m_real, m_imag) for the fused matmul path, uploaded
    once per (kernel, dtype); the kernel object is pinned so its id is
    stable. FIFO-bounded. Inside an active trace (a sharded/plain CQT called
    from a user's jit) nothing is cached — the arrays become trace constants
    and caching them would leak tracers into later traces."""
    from zaftpu.utils.devcache import _tracing_active

    key = (id(kern), np.dtype(dtype).name, "time")
    hit = None if _tracing_active() else _device_kernels.get(key)
    if hit is None:
        m_real = jnp.asarray(
            np.ascontiguousarray(kern.time_kernel.real.T).astype(dtype))
        m_imag = jnp.asarray(
            np.ascontiguousarray(kern.time_kernel.imag.T).astype(dtype))
        hit = (kern, m_real, m_imag)
        if not _tracing_active():
            _device_kernels[key] = hit
            _bound_device_kernels()
    return hit[1], hit[2]


def _device_oracle_kernel(kern: CqtKernel):
    """Device-resident reduced spectral kernel for the f64 oracle path.
    Same no-cache-under-trace rule as :func:`_device_time_kernel`."""
    from zaftpu.utils.devcache import _tracing_active

    key = (id(kern), "oracle")
    hit = None if _tracing_active() else _device_kernels.get(key)
    if hit is None:
        fft_length = kern.fft_length
        k_reduced = np.concatenate([kern.reduced_low, kern.reduced_high],
                                   axis=1)
        all_cols = np.concatenate([kern.columns_low, kern.columns_high])
        gather_cols = np.where(all_cols <= fft_length // 2, all_cols,
                               fft_length - all_cols)
        conj_mask = all_cols > fft_length // 2
        hit = (kern,
               jnp.asarray(k_reduced.astype(np.complex128)),
               jnp.asarray(gather_cols.astype(np.int32)),
               jnp.asarray(conj_mask))
        if not _tracing_active():
            _device_kernels[key] = hit
            _bound_device_kernels()
    return hit[1], hit[2], hit[3]


def _cqt_dispatch(audio_signal, kern, step, number_times, fft_length,
                  octave_resolution):
    pad_front = int(np.ceil((fft_length - step) / 2))
    pad_back = int(np.floor((fft_length - step) / 2))
    # Extra zeros so the last lax.map block can always slice a full segment.
    blocks = -(-number_times // _block_frames())
    needed = _blocked_needed(blocks * _block_frames(), step, fft_length)
    have = int(audio_signal.shape[-1]) + pad_front + pad_back
    pads = (pad_front, pad_back + max(0, needed - have))

    if audio_signal.dtype == jnp.float32:
        # f32 fast path: fused time-domain operator, pure GEMMs
        # (bf16 operands under the compute_dtype("bfloat16") policy).
        m_real, m_imag = _device_time_kernel(
            kern, _policy.operator_dtype(np.float32))
        return _cqt_apply_matmul(
            audio_signal, m_real, m_imag,
            pads, step, fft_length, number_times, _block_frames(),
            octave_resolution)
    # f64 oracle path: batched rfft + reduced kernel matmul, matching the
    # reference's FFT rounding for bit-level parity gates.
    k_reduced, gather_cols, conj_mask = _device_oracle_kernel(kern)
    return _cqt_apply(
        audio_signal, k_reduced, gather_cols, conj_mask,
        pads, step, fft_length, number_times, _block_frames(),
        octave_resolution)


def cqtchromagram(audio_signal, sampling_frequency=None, time_resolution=None,
                  octave_resolution=None, cqt_kernel=None, *, config=None):
    """CQT chromagram ``(octave_resolution, number_times)``.

    Octave fold of the CQT spectrogram: chroma ``i`` sums channels
    ``i, i+OR, i+2*OR, ...`` (reference zaf.py:638-700) — a zero-padded
    reshape-sum fused into the same single-dispatch CQT program.
    Accepts ``config=CqtConfig(...)`` in place of the positional parameters.
    """
    from zaftpu.core import validate as _validate

    if config is not None and octave_resolution is None:
        octave_resolution = config.octave_resolution
    sampling_frequency, time_resolution, cqt_kernel = _resolve_cqt_args(
        sampling_frequency, time_resolution, cqt_kernel, config)
    if octave_resolution is None:
        raise ValueError(
            "octave_resolution is required when no config= is given")
    kern = _as_kernel(cqt_kernel)
    audio_signal = _validate.check_signal(jnp.asarray(audio_signal))
    step = round(float(sampling_frequency) / float(time_resolution))
    number_times = int(audio_signal.shape[-1] // step)
    if number_times < 1:
        raise ValueError(
            f"signal too short: {audio_signal.shape[-1]} samples is less "
            f"than one CQT hop ({step} samples at time_resolution="
            f"{time_resolution})")
    return _cqt_dispatch(audio_signal, kern, step, number_times,
                         kern.fft_length, int(octave_resolution))
