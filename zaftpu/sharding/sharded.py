"""Frame-block-sharded transforms: the long-audio scaling path.

Every analysis transform here shards one long signal (or a batch of them) by
contiguous *frame blocks* over the mesh's ``"frames"`` axis; every synthesis
transform shards the frame axis of the coefficient matrix. The only
communication is the one-hop halo ring from ``zaftpu.sharding.halo`` —
window-overlap halo samples exchanged between neighbouring devices (over
NVLink on a GPU host). Outputs are sharded arrays with values identical to the single-device
transforms (gated against them in tests/test_sharding.py on a virtual
8-device CPU mesh).

Batched inputs (leading axes before the sample axis) compose with data
parallelism: when the mesh also has a ``"batch"`` axis
(:func:`zaftpu.sharding.make_mesh_2d`), the leading dim is sharded over it —
a true DP x SP 2-D layout with halo rings running independently inside each
batch row.

Geometry invariant used throughout: the sharded *body* covers
``t_pad * step`` samples with ``t_pad`` a multiple of the frame-shard count
and large enough that all true signal content lies inside it; everything
beyond is zero padding, so edge shards receiving zero halos is exact, and
surplus frame columns are sliced off at the end.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from zaftpu.core.dispatch import zjit
from zaftpu.core import fft as _fft
from zaftpu.core import frame as _frame
from zaftpu.features.mel import _as_dense, _LOG_EPS, dct_ii_ortho_matrix
from zaftpu.sharding import halo as _halo
from zaftpu.sharding.mesh import BATCH_AXIS, FRAME_AXIS
from zaftpu.core import policy as _policy
from zaftpu.transforms import cqt as _cqt
from zaftpu.transforms.mdct import (_direct_forward_matrix,
                                    _direct_inverse_matrix,
                                    _direct_inverse_windowed_matrix,
                                    _host_window_bytes,
                                    _forward_twiddles, _inverse_twiddles)


def _batch_spec(mesh, n_batch_dims: int):
    """Leading-axis partition entries: dim 0 rides the mesh's batch axis."""
    if n_batch_dims == 0:
        return ()
    first = BATCH_AXIS if BATCH_AXIS in mesh.shape else None
    return (first,) + (None,) * (n_batch_dims - 1)


def _pad_last(x, pad_front: int, pad_back: int):
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad_front, pad_back)])


def _fuse_enabled() -> bool:
    """Single-program sharded transforms (``ZAFTPU_SHARDED_FUSE``, default
    on; ``0`` restores the split bucketed-core/finish structure).

    The split structure compiles the expensive body once per length bucket
    but pays a second full pass over the output (the finish/prep program)
    plus an extra dispatch. The fused mode traces
    prep + sharded body + finish as ONE program keyed additionally on the
    true frame count, so XLA fuses the finish into the body's epilogue the
    same way the single-device transforms do — at the cost of one retrace
    per distinct signal length (exactly the single-device transforms'
    retrace behavior). Many-length sweeps that prefer trace sharing set
    ``ZAFTPU_SHARDED_FUSE=0``; both modes run the identical body function,
    so values are bit-identical (gated in tests/test_sharding.py)."""
    return os.environ.get("ZAFTPU_SHARDED_FUSE", "auto") != "0"


def _bucket_quantum() -> int:
    """Frames-per-shard bucketing quantum (``ZAFTPU_BUCKET_FRAMES``, default
    128; ``0`` disables). Signal lengths are padded up so ``t_pad`` lands on
    a multiple of ``n_shards * quantum`` — many lengths then share one jit
    trace (retrace hygiene). At hour scale the
    wasted frames are <1%; at tiny scale the waste is relatively large but
    absolutely negligible."""
    try:
        return int(os.environ.get("ZAFTPU_BUCKET_FRAMES", "128"))
    except ValueError:
        return 128


def _bucket_t_pad(t_pad: int, n_shards: int) -> int:
    """Bucket a (shard-divisible) frame count to the retrace-hygiene
    quantum — SPLIT mode only. In fused mode the program is keyed on the
    true frame count anyway, so bucket padding buys no trace sharing and
    costs a minor-axis output slice that XLA materializes as a whole extra
    copy pass (with t_pad == t the slice is a no-op and XLA elides it)."""
    if _fuse_enabled():
        return t_pad
    q = _bucket_quantum()
    if q <= 0:
        return t_pad
    quantum = n_shards * q
    return quantum * (-(-t_pad // quantum))


def _plan_body(number_samples: int, pad_front: int, window_length: int,
               step: int, number_times: int, n_shards: int):
    """Frame-count padding so the sharded body holds all signal content.

    Returns ``(t_pad, body_len)`` with ``t_pad % n_shards == 0``,
    ``t_pad >= number_times``, ``body_len = t_pad*step >= pad_front + N``
    (so the halo beyond the body is genuinely zero), and ``t_pad`` bucketed
    to the retrace-hygiene quantum in split mode (exact in fused mode —
    see :func:`_bucket_t_pad`).
    """
    content = pad_front + number_samples
    t_min = max(number_times, -(-content // step))
    t_pad = _bucket_t_pad(n_shards * (-(-t_min // n_shards)), n_shards)
    return t_pad, t_pad * step


def _prepad_tail(x, target_len: int):
    """Eagerly zero-extend the last axis to ``target_len`` so the jitted
    core sees one input shape per length bucket (the eager pad compiles per
    raw length, but in milliseconds — the expensive transform program
    compiles once per bucket)."""
    n = x.shape[-1]
    if n == target_len:
        return x
    return _pad_last(x, 0, target_len - n)


def _sharded_analysis(body, window_length: int, step: int, block_fn, mesh,
                      axis_name: str):
    """shard_map skeleton: pull halo right -> ``block_fn(extended, t_local)``.

    ``body``: ``(..., t_pad*step)`` zero-extended padded signal. Each local
    block receives the halo-extended signal and its local frame count, so
    the family bodies run the SAME framing program as their single-device
    twins (:func:`zaftpu.core.frame.windowed_frames`), which keeps the
    sharded==single-device bit-identity gates intact.
    """
    overlap = window_length - step
    batch = _batch_spec(mesh, body.ndim - 1)

    def local(block):
        extended = _halo.pull_from_right(block, overlap, axis_name)
        t_local = block.shape[-1] // step
        return block_fn(extended, t_local)

    return jax.shard_map(
        local, mesh=mesh, in_specs=P(*batch, axis_name),
        out_specs=P(*batch, axis_name, None))(body)


def _sharded_synthesis(frames, window_length: int, step: int, mesh,
                       axis_name: str):
    """shard_map skeleton: local overlap-add -> push boundary sum right.

    ``frames``: ``(..., t_pad, window_length)`` real frames sharded on the
    frame axis. Returns the ``(..., t_pad*step)`` overlap-added body,
    sharded.
    """
    overlap = window_length - step
    batch = _batch_spec(mesh, frames.ndim - 2)

    def local(block_frames):
        # Same overlap-add program as the single-device synthesis back end.
        ola = _frame.overlap_add(block_frames, step)
        split = block_frames.shape[-2] * step
        body_part = _halo.push_right_sum(ola[..., :split], ola[..., split:],
                                         axis_name)
        return body_part

    return jax.shard_map(
        local, mesh=mesh, in_specs=P(*batch, axis_name, None),
        out_specs=P(*batch, axis_name))(frames)


# ---------------------------------------------------------------------------
# STFT family
# ---------------------------------------------------------------------------

def _stft_plan(n, wl, step, mesh, axis_name):
    pad_front, _, t = _frame.stft_padding(n, wl, step)
    t_pad, body_len = _plan_body(n, pad_front, wl, step, t,
                                 mesh.shape[axis_name])
    return t, (pad_front, body_len, t_pad)


def _stft_half_sharded(audio_signal, window_function, step_length, mesh,
                       axis_name, pads):
    pad_front, body_len, _ = pads
    n = audio_signal.shape[-1]
    body = _pad_last(audio_signal, pad_front, body_len - pad_front - n)
    wl = window_function.shape[0]

    def block_fn(extended, t_local):
        return _fft.windowed_frames_rfft(extended, window_function, wl,
                                         step_length, t_local)

    return _sharded_analysis(body, wl, step_length, block_fn, mesh,
                             axis_name)


def _stft_body(audio_signal, window_function, step_length, mesh,
               axis_name, pads, magnitude):
    """Sharded STFT body: frames-major half spectrum as (re, im) f32/f64
    planes, or the magnitude ``(t_pad, WL/2)`` when ``magnitude``. Shared
    verbatim by the fused single-program mode and the split bucketed mode
    (:func:`_fuse_enabled`), so the two are bit-identical."""
    if magnitude:
        return _spectrogram_body_sharded(audio_signal, window_function,
                                         step_length, mesh, axis_name,
                                         pads)
    half = _stft_half_sharded(audio_signal, window_function, step_length,
                              mesh, axis_name, pads)
    # real()/imag() of the upstream lax.complex fuse away on the engine
    # path — the half spectrum is never materialized as complex there.
    return jnp.real(half), jnp.imag(half)


def _spectrogram_body_sharded(audio_signal, window_function, step_length,
                              mesh, axis_name, pads):
    """Magnitude body: the windowed-rfft + abs program per shard (abs is
    elementwise, so folding it into the shard_map body is value-identical
    to the single-device spectrogram)."""
    pad_front, body_len, _ = pads
    n = audio_signal.shape[-1]
    body = _pad_last(audio_signal, pad_front, body_len - pad_front - n)
    wl = window_function.shape[0]

    def block_fn(extended, t_local):
        half = _fft.windowed_frames_rfft(extended, window_function, wl,
                                         step_length, t_local)
        return jnp.abs(half[..., 1:])

    return _sharded_analysis(body, wl, step_length, block_fn, mesh,
                             axis_name)


# Split-mode body (bucketed): this trace serves every signal length in a
# bucket (the wrapper pre-pads the input to the bucket shape); the
# mirror/transpose/true-length slice happen in :func:`_stft_finish`, a
# separate small jitted program keyed on the true frame count.
_stft_full_sharded = zjit(_stft_body,
                          static_argnames=("step_length", "mesh",
                                           "axis_name", "pads", "magnitude"))


@partial(zjit, static_argnames=("step_length", "mesh", "axis_name",
                                   "pads", "magnitude", "number_times"))
def _stft_fused(audio_signal, window_function, step_length, mesh,
                axis_name, pads, magnitude, number_times):
    """Fused single-program sharded STFT/spectrogram: body + finish in ONE
    jitted dispatch, keyed additionally on the true frame count, so the
    finish (mirror/transpose/slice) fuses into the body's epilogue instead
    of paying a second full pass over the output."""
    out = _stft_body(audio_signal, window_function, step_length, mesh,
                     axis_name, pads, magnitude)
    if magnitude:
        return _transpose_slice_ops(out, number_times)
    wl = window_function.shape[0]
    return _stft_finish_ops(out[0], out[1], wl, number_times)


def _transpose_slice_ops(frames_major, number_times):
    """``swapaxes(x, -1, -2)[..., :t]`` — the shared finish step for
    frames-major real outputs (magnitude spectrogram, MDCT coefficients).
    Transpose first, then slice the (now minor) frame axis."""
    return jnp.swapaxes(frames_major, -1, -2)[..., :number_times]


_transpose_slice = zjit(_transpose_slice_ops,
                        static_argnames=("number_times",))


def _stft_finish_ops(re_half, im_half, window_length, number_times):
    """Mirror + transpose + true-length slice: reads the half planes
    (frames-major), writes the ``(WL, number_times)`` complex output once."""
    half = jax.lax.complex(re_half[..., :number_times, :],
                           im_half[..., :number_times, :])
    full = _fft.full_from_half(half, window_length)
    return jnp.swapaxes(full, -1, -2)


# Split-mode finish: a separate small jitted program keyed on the true
# frame count, so per-length retraces stay cheap while the expensive body
# trace stays bucketed.
_stft_finish = zjit(_stft_finish_ops,
                    static_argnames=("window_length", "number_times"))


def stft_sharded(audio_signal, window_function, step_length: int, mesh,
                 axis_name: str = FRAME_AXIS):
    """Frame-block-sharded STFT; values identical to :func:`zaftpu.stft`.

    The signal is sharded in contiguous ``t_local*step`` sample blocks; each
    shard pulls a ``window_length - step`` halo from its right neighbor (one
    ``ppermute`` hop) and runs the batched windowed rfft locally. Returns the
    full-spectrum ``(..., window_length, number_times)`` STFT sharded over
    the time axis (and batched leading dims over the mesh's batch axis, if
    present).
    """
    from zaftpu.utils.devcache import as_device_constant

    audio_signal = jnp.asarray(audio_signal)
    window_function = as_device_constant(window_function)
    wl = window_function.shape[0]
    t, pads = _stft_plan(audio_signal.shape[-1], wl, int(step_length), mesh,
                         axis_name)
    if _fuse_enabled():
        # No eager prepad in fused mode: the program is keyed on the true
        # length and pads in-trace (an eager copy is a whole extra pass).
        return _stft_fused(audio_signal, window_function, int(step_length),
                           mesh, axis_name, pads, False, t)
    audio_signal = _prepad_tail(audio_signal, pads[1] - pads[0])
    re_half, im_half = _stft_full_sharded(
        audio_signal, window_function, int(step_length), mesh, axis_name,
        pads, False)
    return _stft_finish(re_half, im_half, wl, t)


def spectrogram_sharded(audio_signal, window_function, step_length: int,
                        mesh, axis_name: str = FRAME_AXIS):
    """Sharded magnitude spectrogram over bins ``1..WL/2`` (``(WL/2, T)``)."""
    from zaftpu.utils.devcache import as_device_constant

    audio_signal = jnp.asarray(audio_signal)
    window_function = as_device_constant(window_function)
    wl = window_function.shape[0]
    t, pads = _stft_plan(audio_signal.shape[-1], wl, int(step_length), mesh,
                         axis_name)
    if _fuse_enabled():
        return _stft_fused(audio_signal, window_function, int(step_length),
                           mesh, axis_name, pads, True, t)
    audio_signal = _prepad_tail(audio_signal, pads[1] - pads[0])
    mag = _stft_full_sharded(audio_signal, window_function,
                             int(step_length), mesh, axis_name, pads, True)
    return _transpose_slice(mag, t)


def _istft_plain_body(audio_stft, step_length, mesh, axis_name, gain,
                      frames_pad, out_length):
    """Non-engine (native-FFT / f64 oracle) sharded synthesis: frame-axis
    pad to ``frames_pad`` (zero frame columns contribute nothing to the
    overlap-add), inverse FFT, sharded OLA, trim."""
    t = audio_stft.shape[-1]
    padded = jnp.pad(
        audio_stft,
        [(0, 0)] * (audio_stft.ndim - 2) + [(0, 0), (0, frames_pad - t)])
    wl = padded.shape[-2]
    frames_major = jnp.swapaxes(padded, -1, -2)
    frames = _fft.real_ifft(frames_major)
    body = _sharded_synthesis(frames, wl, step_length, mesh, axis_name)
    out = body[..., wl - step_length:]
    out = out / jnp.asarray(gain, dtype=out.dtype)
    if out_length is not None:
        out = out[..., :out_length]
    return out


_istft_core_sharded = zjit(
    _istft_plain_body,
    static_argnames=("step_length", "mesh", "axis_name", "gain",
                     "frames_pad", "out_length"))


def _istft_prep_ops(audio_stft, window_length, frames_pad):
    """Engine-path prep: transpose + Hermitian fold + frame-axis pad to
    ``frames_pad`` in ONE pass over the complex input, producing
    ``(h_re, h_im)`` float planes ``(..., frames_pad, WL/2+1)``. Zero
    spectrum columns fold to zero planes, so padding after the fold is
    exact."""
    fm = jnp.swapaxes(audio_stft, -1, -2)
    h_re, h_im = _fft.hermitian_fold_planes(jnp.real(fm), jnp.imag(fm),
                                            window_length)
    pad = ([(0, 0)] * (h_re.ndim - 2)
           + [(0, frames_pad - h_re.shape[-2]), (0, 0)])
    return jnp.pad(h_re, pad), jnp.pad(h_im, pad)


_istft_prep = zjit(_istft_prep_ops,
                   static_argnames=("window_length", "frames_pad"))


def _istft_folded_body(h_re, h_im, window_length, step_length, mesh,
                       axis_name, gain):
    """Engine-path sharded synthesis from pre-folded Hermitian planes: the
    COLA gain folds into the inverse operator columns (same as the
    single-device synthesis_ola) — kills the post-OLA elementwise pass over
    the output signal."""
    frames = _fft.direct_real_ifft_folded(h_re, h_im, window_length,
                                          scale=1.0 / gain)
    body = _sharded_synthesis(frames, window_length, step_length, mesh,
                              axis_name)
    # Reference trim [wl-step : T*step) of the pre-trim signal (zaf.py:236).
    return body[..., window_length - step_length:]


# Split-mode core (bucketed trace); bit-identical composition with
# :func:`_istft_prep` to the former single-core program.
_istft_core_sharded_folded = zjit(
    _istft_folded_body,
    static_argnames=("window_length", "step_length", "mesh", "axis_name",
                     "gain"))


@partial(zjit, static_argnames=("window_length", "step_length", "mesh",
                                   "axis_name", "gain", "frames_pad",
                                   "out_length"))
def _istft_fused(audio_stft, window_length, step_length, mesh, axis_name,
                 gain, frames_pad, out_length):
    """Fused single-program engine-path sharded ISTFT: prep (transpose +
    Hermitian fold + pad) + sharded synthesis + true-length slice in ONE
    jitted dispatch, so the fold fuses into the GEMM feed and the final
    slice into the OLA epilogue (the split structure pays a separate full
    pass for each)."""
    h_re, h_im = _istft_prep_ops(audio_stft, window_length, frames_pad)
    out = _istft_folded_body(h_re, h_im, window_length, step_length, mesh,
                             axis_name, gain)
    return out[..., :out_length]


def istft_sharded(audio_stft, window_function, step_length: int, mesh,
                  axis_name: str = FRAME_AXIS):
    """Frame-block-sharded inverse STFT with boundary-sum halo exchange.

    Each shard overlap-adds its local frames, then pushes the
    ``window_length - step`` samples that spill into its right neighbor's
    region through one ``ppermute`` hop; the neighbor sums them into its
    block head. Values identical to :func:`zaftpu.istft`.
    """
    audio_stft = jnp.asarray(audio_stft)
    step = int(step_length)
    wl, t = audio_stft.shape[-2], audio_stft.shape[-1]
    n_shards = mesh.shape[axis_name]
    t_pad = _bucket_t_pad(n_shards * (-(-t // n_shards)), n_shards)
    gain = _frame.cola_gain(np.asarray(window_function), step)
    out_length = t * step - (wl - step)
    if _fft.direct_engine_enabled(wl):
        if _fuse_enabled():
            return _istft_fused(audio_stft, wl, step, mesh, axis_name,
                                gain, t_pad, out_length)
        h_re, h_im = _istft_prep(audio_stft, wl, t_pad)
        out = _istft_core_sharded_folded(h_re, h_im, wl, step, mesh,
                                         axis_name, gain)
        return out[..., :out_length]
    return _istft_core_sharded(audio_stft, step, mesh, axis_name, gain,
                               t_pad, out_length)


# ---------------------------------------------------------------------------
# Mel features (sharded spectrogram + replicated filterbank matmuls)
# ---------------------------------------------------------------------------

@partial(zjit, static_argnames=("step_length", "mesh", "axis_name",
                                   "pads", "power", "number_coefficients",
                                   "number_times"))
def _mel_full_sharded(audio_signal, window_function, fbank_t, dct_t,
                      step_length, mesh, axis_name, pads, power,
                      number_coefficients, number_times=None):
    """Sharded mel spectrogram (power=False) or MFCCs (power=True,
    number_coefficients>0) in one jitted dispatch. With ``number_times``
    (fused mode, the default) the true-frame-count slice happens in the
    same program; with ``None`` (``ZAFTPU_SHARDED_FUSE=0``) the output is
    ``t_pad`` wide and the wrapper slices eagerly (bucketed trace
    sharing)."""
    mel = _mel_core_sharded(audio_signal, window_function, fbank_t,
                            step_length, mesh, axis_name, pads, power)
    if number_coefficients:
        logmel = jnp.log(mel + jnp.asarray(_LOG_EPS, mel.dtype))
        cepstra = _policy.operator_matmul(logmel, dct_t)
        out = jnp.swapaxes(cepstra, -1, -2)
        out = out[..., 1:number_coefficients + 1, :]
    else:
        out = jnp.swapaxes(mel, -1, -2)
    if number_times is not None:
        out = out[..., :number_times]
    return out


def _mel_core_sharded(audio_signal, window_function, fbank_t, step_length,
                      mesh, axis_name, pads, power):
    pad_front, body_len, _ = pads
    n = audio_signal.shape[-1]
    body = _pad_last(audio_signal, pad_front, body_len - pad_front - n)
    wl = window_function.shape[0]

    def block_fn(extended, t_local):
        half = _fft.windowed_frames_rfft(extended, window_function, wl,
                                         step_length, t_local)
        mag = jnp.abs(half[..., 1:])
        if power:
            mag = mag * mag
        return _policy.operator_matmul(mag, fbank_t)

    return _sharded_analysis(body, wl, step_length, block_fn, mesh,
                             axis_name)


def melspectrogram_sharded(audio_signal, window_function, step_length: int,
                           mel_filterbank, mesh,
                           axis_name: str = FRAME_AXIS):
    """Sharded mel spectrogram ``(number_mels, T)`` — filterbank replicated,
    spectrogram frames sharded; one fused windowed-rfft + matmul per
    shard."""
    from zaftpu.utils.devcache import as_device_constant, device_constant

    audio_signal = jnp.asarray(audio_signal)
    window_function = as_device_constant(window_function)
    fbank = _as_dense(mel_filterbank)
    wl = window_function.shape[0]
    t, pads = _stft_plan(audio_signal.shape[-1], wl, int(step_length), mesh,
                         axis_name)
    # Same roofline exemption as the unsharded transform (policy.BF16_EXEMPT)
    # so sharded == single-device holds under the bf16 dial too.
    op_dtype = _policy.operator_dtype(audio_signal.dtype,
                                      transform="melspectrogram")
    fused = _fuse_enabled()
    if not fused:
        audio_signal = _prepad_tail(audio_signal, pads[1] - pads[0])
    out = _mel_full_sharded(audio_signal, window_function,
                            device_constant(
                                np.ascontiguousarray(fbank.T), op_dtype),
                            jnp.zeros(()),
                            int(step_length), mesh, axis_name, pads, False,
                            0, t if fused else None)
    return out if fused else out[..., :t]


def mfcc_sharded(audio_signal, window_function, step_length: int,
                 mel_filterbank, number_coefficients: int, mesh,
                 axis_name: str = FRAME_AXIS):
    """Sharded MFCCs ``(number_coefficients, T)``."""
    from zaftpu.utils.devcache import as_device_constant, device_constant

    audio_signal = jnp.asarray(audio_signal)
    window_function = as_device_constant(window_function)
    fbank = _as_dense(mel_filterbank)
    dct_mat = dct_ii_ortho_matrix(fbank.shape[0])
    wl = window_function.shape[0]
    t, pads = _stft_plan(audio_signal.shape[-1], wl, int(step_length), mesh,
                         axis_name)
    # Same roofline exemption as the unsharded transform (policy.BF16_EXEMPT).
    op_dtype = _policy.operator_dtype(audio_signal.dtype, transform="mfcc")
    fused = _fuse_enabled()
    if not fused:
        audio_signal = _prepad_tail(audio_signal, pads[1] - pads[0])
    out = _mel_full_sharded(audio_signal, window_function,
                            device_constant(
                                np.ascontiguousarray(fbank.T), op_dtype),
                            device_constant(
                                np.ascontiguousarray(dct_mat.T), op_dtype),
                            int(step_length), mesh, axis_name, pads, True,
                            int(number_coefficients), t if fused else None)
    return out if fused else out[..., :t]


# ---------------------------------------------------------------------------
# MDCT family
# ---------------------------------------------------------------------------

@partial(zjit, static_argnames=("mesh", "axis_name", "pads",
                                   "number_times"))
def _mdct_full_sharded(audio_signal, window_function, pre, post, mesh,
                       axis_name, pads, number_times=None):
    """Twiddle-path sharded MDCT body: FRAMES-MAJOR coefficients
    ``(..., t_pad, WL/2)``, or — with ``number_times`` (fused mode) — the
    bins-major true-length output with the transpose+slice in the same
    program."""
    out = _mdct_core_sharded(audio_signal, window_function, pre, post,
                             mesh, axis_name, pads)
    if number_times is not None:
        out = _transpose_slice_ops(out, number_times)
    return out


@partial(zjit, static_argnames=("mesh", "axis_name", "pads",
                                   "number_times"))
def _mdct_full_sharded_direct(audio_signal, window_function, mesh,
                              axis_name, pads, number_times=None):
    """Direct-GEMM sharded MDCT: same folded (WL, WL/2) operator as the
    single-device path, so the value-identity contract holds under
    ``ZAFTPU_FFT=matmul`` too. FRAMES-MAJOR output ``(..., t_pad, WL/2)``
    when ``number_times`` is None (split mode — the wrapper's
    :func:`_transpose_slice` fuses transpose + slice as a second program);
    with ``number_times`` (fused mode) the transpose+slice runs in this
    same program, where XLA folds it into the GEMM output layout. The
    operator enters as a trace-time constant, as on the single-device
    path."""
    pad_front, body_len, _ = pads
    wl = window_function.shape[0]
    step = wl // 2
    n = audio_signal.shape[-1]
    body = _pad_last(audio_signal, pad_front, body_len - pad_front - n)
    rdtype = (np.float32 if audio_signal.dtype == jnp.float32
              else np.float64)

    def matrix():
        return jnp.asarray(_direct_forward_matrix(wl).astype(rdtype))

    def block_fn(extended, t_local):
        frames = _frame.windowed_frames(extended, window_function, wl, step,
                                        t_local)
        return _policy.real_matmul(frames, matrix().astype(frames.dtype))

    out = _sharded_analysis(body, wl, step, block_fn, mesh, axis_name)
    if number_times is not None:
        out = _transpose_slice_ops(out, number_times)
    return out


def _mdct_core_sharded(audio_signal, window_function, pre, post, mesh,
                       axis_name, pads):
    pad_front, body_len, _ = pads
    wl = window_function.shape[0]
    step = wl // 2
    n = audio_signal.shape[-1]
    body = _pad_last(audio_signal, pad_front, body_len - pad_front - n)

    def block_fn(extended, t_local):
        frames = _frame.windowed_frames(extended, window_function, wl, step,
                                        t_local)
        spectra = _fft.fft(
            frames * pre.astype(jnp.result_type(frames, pre)))
        return jnp.real(spectra[..., :step] * post)

    return _sharded_analysis(body, wl, step, block_fn, mesh, axis_name)


def mdct_sharded(audio_signal, window_function, mesh,
                 axis_name: str = FRAME_AXIS):
    """Frame-block-sharded MDCT ``(WL/2, number_times)``; values identical
    to :func:`zaftpu.mdct`."""
    audio_signal = jnp.asarray(audio_signal)
    window_function = np.asarray(window_function)
    wl = window_function.shape[0]
    step = wl // 2
    n = audio_signal.shape[-1]
    t = int(np.ceil(n / step)) + 1
    t_pad, body_len = _plan_body(n, step, wl, step, t, mesh.shape[axis_name])
    from zaftpu.utils.devcache import as_device_constant, device_constant

    fused = _fuse_enabled()
    if not fused:
        # Fused mode pads in-trace (the eager copy is a whole extra pass).
        audio_signal = _prepad_tail(audio_signal, body_len - step)
    if _fft.direct_engine_enabled(wl):
        out = _mdct_full_sharded_direct(
            audio_signal, as_device_constant(window_function),
            mesh, axis_name, (step, body_len, t_pad),
            t if fused else None)
        return out if fused else _transpose_slice(out, t)
    pre, post = _forward_twiddles(wl)
    ctype = np.complex64 if audio_signal.dtype == jnp.float32 else np.complex128
    out = _mdct_full_sharded(
        audio_signal, as_device_constant(window_function),
        device_constant(pre, ctype), device_constant(post, ctype),
        mesh, axis_name, (step, body_len, t_pad), t if fused else None)
    return out if fused else _transpose_slice(out, t)


def _imdct_prep_ops(audio_mdct, frames_pad):
    """Transpose to frames-major + frame-axis pad to ``frames_pad`` in ONE
    pass over the coefficient matrix."""
    coeffs = jnp.swapaxes(audio_mdct, -1, -2)
    pad = ([(0, 0)] * (coeffs.ndim - 2)
           + [(0, frames_pad - coeffs.shape[-2]), (0, 0)])
    return jnp.pad(coeffs, pad)


_imdct_prep = zjit(_imdct_prep_ops, static_argnames=("frames_pad",))


@partial(zjit, static_argnames=("wbytes", "mesh", "axis_name",
                                   "frames_pad", "out_length"))
def _imdct_fused_direct(audio_mdct, wbytes, mesh, axis_name, frames_pad,
                        out_length):
    """Fused single-program direct-GEMM sharded inverse MDCT: prep
    (transpose + pad) + window-folded GEMM + TDAC boundary-sum exchange +
    reference trim in ONE jitted dispatch."""
    coeffs = _imdct_prep_ops(audio_mdct, frames_pad)
    out = _imdct_direct_body(coeffs, wbytes, mesh, axis_name)
    return out[..., :out_length]


@partial(zjit, static_argnames=("mesh", "axis_name"))
def _imdct_core_sharded(coeffs, window_function, pre, post, mesh,
                        axis_name):
    """FRAMES-MAJOR input ``(..., t_pad, F)`` (from :func:`_imdct_prep`);
    returns the body after the front trim — the wrapper slices the true
    length."""
    f = coeffs.shape[-1]
    ctype = jnp.result_type(coeffs, pre)
    spectra = _fft.fft(coeffs * pre.astype(ctype), n=2 * f)
    frames = 2.0 * jnp.real(spectra * post) * window_function.astype(
        jnp.real(spectra).dtype)
    body = _sharded_synthesis(frames, 2 * f, f, mesh, axis_name)
    return body[..., f:]


def _imdct_direct_body(coeffs, wbytes, mesh, axis_name):
    """Direct-GEMM sharded inverse MDCT body: the window-folded (F, 2F)
    operator of the single-device path (pre/FFT/post/2*Re/window fused), so
    values stay identical under ``ZAFTPU_FFT=matmul``. FRAMES-MAJOR input;
    the operator is a trace-time constant keyed by the static window
    bytes."""
    f = coeffs.shape[-1]
    rdtype = np.float32 if coeffs.dtype == jnp.float32 else np.float64
    matrix = jnp.asarray(
        _direct_inverse_windowed_matrix(f, wbytes).astype(rdtype))
    frames = _policy.real_matmul(coeffs, matrix.astype(coeffs.dtype))
    body = _sharded_synthesis(frames, 2 * f, f, mesh, axis_name)
    return body[..., f:]


_imdct_core_sharded_direct = zjit(
    _imdct_direct_body, static_argnames=("wbytes", "mesh", "axis_name"))


@partial(zjit, static_argnames=("mesh", "axis_name"))
def _imdct_core_sharded_direct_unfused(coeffs, window_function, mesh,
                                       axis_name):
    """Traced/device-resident window twin — post-GEMM multiply, matching
    :func:`zaftpu.transforms.mdct._imdct_direct_core_unfused`."""
    f = coeffs.shape[-1]
    rdtype = np.float32 if coeffs.dtype == jnp.float32 else np.float64
    matrix = jnp.asarray(_direct_inverse_matrix(f).astype(rdtype))
    frames = _policy.real_matmul(coeffs, matrix.astype(coeffs.dtype))
    frames = frames * window_function.astype(frames.dtype)
    body = _sharded_synthesis(frames, 2 * f, f, mesh, axis_name)
    return body[..., f:]


def imdct_sharded(audio_mdct, window_function, mesh,
                  axis_name: str = FRAME_AXIS):
    """Frame-block-sharded inverse MDCT with TDAC boundary-sum exchange;
    values identical to :func:`zaftpu.imdct`."""
    audio_mdct = jnp.asarray(audio_mdct)
    f, t = audio_mdct.shape[-2], audio_mdct.shape[-1]
    n_shards = mesh.shape[axis_name]
    t_pad = _bucket_t_pad(n_shards * (-(-t // n_shards)), n_shards)
    from zaftpu.utils.devcache import as_device_constant, device_constant

    if _fft.direct_engine_enabled(2 * f):
        wbytes = _host_window_bytes(window_function)
        if wbytes is not None and _fuse_enabled():
            # Reference trim [F : F*(T+1)-F-1) (zaf.py:1182): len F*T-F-1.
            return _imdct_fused_direct(audio_mdct, wbytes, mesh, axis_name,
                                       t_pad, f * t - f - 1)
        padded = _imdct_prep(audio_mdct, t_pad)
        if wbytes is None:
            out = _imdct_core_sharded_direct_unfused(
                padded, as_device_constant(window_function), mesh,
                axis_name)
        else:
            out = _imdct_core_sharded_direct(padded, wbytes, mesh,
                                             axis_name)
        return out[..., :f * t - f - 1]
    padded = _imdct_prep(audio_mdct, t_pad)
    pre, post = _inverse_twiddles(f)
    ctype = np.complex64 if audio_mdct.dtype == jnp.float32 else np.complex128
    out = _imdct_core_sharded(
        padded, as_device_constant(window_function),
        device_constant(pre, ctype), device_constant(post, ctype),
        mesh, axis_name)
    # Reference trim [F : F*(T+1) - F - 1) (zaf.py:1182): length F*T - F - 1.
    return out[..., :f * t - f - 1]


# ---------------------------------------------------------------------------
# CQT family
# ---------------------------------------------------------------------------

@partial(zjit, static_argnames=("step_length", "fft_length", "mesh",
                                   "axis_name", "pads", "block_frames", "t",
                                   "octave_resolution"))
def _cqt_core_sharded(padless_signal, m_real, m_imag, step_length,
                      fft_length, mesh, axis_name, pads, block_frames, t,
                      octave_resolution):
    pad_front, body_len, _ = pads
    n = padless_signal.shape[-1]
    body = _pad_last(padless_signal, pad_front, body_len - pad_front - n)
    overlap = fft_length - step_length
    batch = _batch_spec(mesh, body.ndim - 1)

    def local(block):
        extended = _halo.pull_from_right(block, overlap, axis_name)
        t_local = block.shape[-1] // step_length
        b = min(block_frames, t_local)
        # Zero-extend so the last lax.map block can slice a full segment
        # (surplus frames are discarded by the impl's [:t_local] slice).
        blocks = -(-t_local // b)
        needed = _cqt._blocked_needed(blocks * b, step_length, fft_length)
        extended = _pad_last(extended, 0,
                             max(0, needed - extended.shape[-1]))
        return _cqt._batched_1d(_cqt._blocked_matmul_impl)(
            extended, m_real, m_imag, step_length, fft_length, t_local, b)

    out = jax.shard_map(
        local, mesh=mesh, in_specs=P(*batch, axis_name),
        out_specs=P(*batch, axis_name, None))(body)
    spec = jnp.swapaxes(out, -1, -2)[..., :t]
    if octave_resolution:
        return _cqt._octave_fold(spec, octave_resolution)
    return spec


def cqtspectrogram_sharded(audio_signal, sampling_frequency, time_resolution,
                           cqt_kernel, mesh, axis_name: str = FRAME_AXIS):
    """Frame-block-sharded CQT spectrogram (fused time-domain matmul path,
    in the input's dtype).

    The halo here is ``fft_length - step`` samples (the CQT's analysis reach,
    ~31k samples at the default kernel) — pulled over as many ``ppermute``
    hops as it spans shards.
    """
    kern = _cqt._as_kernel(cqt_kernel)
    audio_signal = jnp.asarray(audio_signal)
    step = round(float(sampling_frequency) / float(time_resolution))
    n = int(audio_signal.shape[-1])
    t = n // step
    fft_length = kern.fft_length
    pad_front = int(np.ceil((fft_length - step) / 2))
    t_pad, body_len = _plan_body(n, pad_front, fft_length, step, t,
                                 mesh.shape[axis_name])
    kdtype = (_policy.operator_dtype(np.float32)
              if audio_signal.dtype == jnp.float32 else np.float64)
    m_real, m_imag = _cqt._device_time_kernel(kern, kdtype)
    return _cqt_core_sharded(
        audio_signal, m_real, m_imag,
        step, fft_length, mesh, axis_name,
        (pad_front, body_len, t_pad), _cqt._block_frames(), t, 0)


_TP_PAD_CACHE: dict = {}


def _tp_padded_kernel(m_real, m_imag, f_pad: int):
    """Zero-pad the device kernel pair to a shard-divisible channel count,
    once per (kernel, f_pad) instead of re-concatenating ~38 MB of operator
    on every call. Keys on the identity of `_device_time_kernel`'s cached
    arrays (pinned in the value so the ids stay live); FIFO-bounded."""
    key = (id(m_real), id(m_imag), f_pad)
    hit = _TP_PAD_CACHE.get(key)
    if hit is None:
        while len(_TP_PAD_CACHE) >= 8:
            _TP_PAD_CACHE.pop(next(iter(_TP_PAD_CACHE)))
        zeros = jnp.zeros((m_real.shape[0], f_pad - m_real.shape[1]),
                          m_real.dtype)
        hit = (jnp.concatenate([m_real, zeros], axis=1),
               jnp.concatenate([m_imag, zeros], axis=1), m_real, m_imag)
        _TP_PAD_CACHE[key] = hit
    return hit[0], hit[1]


@partial(zjit, static_argnames=("step_length", "fft_length", "mesh",
                                   "axis_name", "pads", "block_frames"))
def _cqt_tp_core(padless_signal, m_real, m_imag, step_length, fft_length,
                 mesh, axis_name, pads, block_frames):
    pad_front, body_len, t_pad = pads
    n = padless_signal.shape[-1]
    padded = _pad_last(padless_signal, pad_front, body_len - pad_front - n)
    batch = _batch_spec(mesh, padded.ndim - 1)

    def local(mr, mi, sig):
        # Per-channel outputs are independent, so the F-sharded (TP) slice
        # stays value-identical to the single-device columns.
        return _cqt._batched_1d(_cqt._blocked_matmul_impl)(
            sig, mr, mi, step_length, fft_length, t_pad,
            min(block_frames, t_pad))

    out = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, axis_name), P(None, axis_name), P(*batch)),
        out_specs=P(*batch, None, axis_name))(
        m_real, m_imag, padded)
    return jnp.swapaxes(out, -1, -2)


def cqtspectrogram_tp(audio_signal, sampling_frequency, time_resolution,
                      cqt_kernel, mesh, axis_name: str = FRAME_AXIS):
    """Tensor-parallel CQT spectrogram: the *frequency axis* of the fused
    time-domain kernel is sharded over ``mesh``'s ``axis_name`` axis, with
    the signal replicated (SURVEY.md §2.3's TP row).

    Each device holds ``F / n_shards`` kernel columns (~38 MB/n_shards of
    operator state at the default 144x32768 kernel, reference workload
    zaf.py:627-633) and computes every frame for its channel slice — zero
    per-frame communication; the output is sharded on the channel axis.
    Complementary to :func:`cqtspectrogram_sharded` (frame/sequence
    parallel): frame sharding wins whenever ``T >> F`` (any signal over a
    few seconds — docs/sharding.md); TP helps short-signal latency and
    divides kernel memory.
    """
    from zaftpu.core import validate as _validate

    kern = _cqt._as_kernel(cqt_kernel)
    audio_signal = _validate.check_signal(jnp.asarray(audio_signal))
    step = round(float(sampling_frequency) / float(time_resolution))
    n = int(audio_signal.shape[-1])
    t = n // step
    if t < 1:
        raise ValueError("signal shorter than one CQT hop")
    fft_length = kern.fft_length
    pad_front = int(np.ceil((fft_length - step) / 2))
    n_shards = mesh.shape[axis_name]

    kdtype = (_policy.operator_dtype(np.float32)
              if audio_signal.dtype == jnp.float32 else np.float64)
    m_real, m_imag = _cqt._device_time_kernel(kern, kdtype)
    n_freq = m_real.shape[1]
    f_pad = n_shards * (-(-n_freq // n_shards))
    if f_pad != n_freq:
        m_real, m_imag = _tp_padded_kernel(m_real, m_imag, f_pad)

    # Frame-count padding so every lax.map block slices a full segment.
    block = min(_cqt._block_frames(), max(1, t))
    t_pad = block * (-(-t // block))
    body_len = max(pad_front + n,
                   _cqt._blocked_needed(t_pad, step, fft_length))
    out = _cqt_tp_core(audio_signal, m_real, m_imag, step, fft_length,
                       mesh, axis_name, (pad_front, body_len, t_pad), block)
    return out[..., :n_freq, :t]


def cqtchromagram_sharded(audio_signal, sampling_frequency, time_resolution,
                          octave_resolution, cqt_kernel, mesh,
                          axis_name: str = FRAME_AXIS):
    """Sharded CQT chromagram — octave fold fused into the same single
    jitted dispatch as the sharded spectrogram."""
    kern = _cqt._as_kernel(cqt_kernel)
    audio_signal = jnp.asarray(audio_signal)
    step = round(float(sampling_frequency) / float(time_resolution))
    n = int(audio_signal.shape[-1])
    t = n // step
    fft_length = kern.fft_length
    pad_front = int(np.ceil((fft_length - step) / 2))
    t_pad, body_len = _plan_body(n, pad_front, fft_length, step, t,
                                 mesh.shape[axis_name])
    kdtype = (_policy.operator_dtype(np.float32)
              if audio_signal.dtype == jnp.float32 else np.float64)
    m_real, m_imag = _cqt._device_time_kernel(kern, kdtype)
    return _cqt_core_sharded(
        audio_signal, m_real, m_imag,
        step, fft_length, mesh, axis_name,
        (pad_front, body_len, t_pad), _cqt._block_frames(), t,
        int(octave_resolution))
