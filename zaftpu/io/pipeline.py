"""Resumable streaming analysis of arbitrarily long recordings.

The failure-recovery model (SURVEY.md §5): transforms are stateless and
frame-local, so recovery = re-run the failed frame block. This module makes
that operational — a long WAV is analyzed block-by-block through
:class:`zaftpu.io.stream.BlockReader` spans, each block's features are
checkpointed to disk as soon as they're computed, and a restarted job skips
every block that already has a checkpoint. Host memory and device memory stay
bounded regardless of signal length; results are bit-identical to the
whole-signal transforms (gated in tests/test_pipeline.py).

Frame-grid geometry: global frame ``j`` covers padded-signal samples
``[j*step, j*step + window_length)`` where the padded stream is
``pad_front`` zeros + signal + trailing zeros — exactly the single-device
transform geometry, served lazily via ``read_span``.
"""

from __future__ import annotations

import os

import numpy as np

from zaftpu.core.dispatch import zjit
from zaftpu.io.stream import BlockReader


class StreamingTransform:
    """Drive a per-frame-block feature function over a long WAV, resumably.

    Args:
        path: WAV file.
        window_length, step: frame geometry.
        pad_front: zeros prepended to the stream (centering pad).
        number_times: total frames to produce.
        block_fn: ``(samples (block_frames*step + window_length - step,))
            -> features (block_frames, F)`` — a jitted device function.
        block_frames: frames per block.
        checkpoint_dir: directory for per-block ``.npy`` checkpoints
            (None = no checkpointing).
    """

    def __init__(self, path, window_length: int, step: int, pad_front: int,
                 number_times: int, block_fn, block_frames: int = 4096,
                 checkpoint_dir: str | None = None):
        self.reader = BlockReader(path, block_samples=block_frames * step,
                                  overlap=window_length - step)
        self.window_length = window_length
        self.step = step
        self.pad_front = pad_front
        self.number_times = number_times
        self.block_fn = block_fn
        self.block_frames = block_frames
        self.checkpoint_dir = checkpoint_dir
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)

    @property
    def num_blocks(self) -> int:
        return -(-self.number_times // self.block_frames)

    def _ckpt_path(self, index: int) -> str:
        return os.path.join(self.checkpoint_dir, f"block{index:08d}.npy")

    def dispatch_block(self, index: int):
        """Read + upload + dispatch one block's device program WITHOUT
        fetching the result — JAX dispatch is asynchronous, so the device
        keeps computing while the host reads/uploads the next block or
        fetches an earlier one."""
        first_frame = index * self.block_frames
        span_start = first_frame * self.step - self.pad_front
        span_len = (self.block_frames * self.step
                    + self.window_length - self.step)
        samples = self.reader.read_span(span_start, span_len)
        return self.block_fn(samples)

    def _fetch_block(self, index: int, dev) -> np.ndarray:
        keep = min(self.block_frames,
                   self.number_times - index * self.block_frames)
        return np.asarray(dev)[:keep]

    def compute_block(self, index: int) -> np.ndarray:
        """Features for frames ``[index*B, min((index+1)*B, T))``."""
        return self._fetch_block(index, self.dispatch_block(index))

    def run(self, progress=None, prefetch: int = 2):
        """All blocks, resuming from checkpoints; returns ``(T, F)``.

        Software-pipelined: up to ``prefetch`` blocks stay in flight on the
        device, so block ``k``'s host fetch/checkpoint overlaps block
        ``k+1``'s device compute (double-buffering by default).
        """
        import collections

        results: dict = {}
        inflight: collections.deque = collections.deque()

        def drain(limit: int):
            while len(inflight) > limit:
                i, dev = inflight.popleft()
                block = self._fetch_block(i, dev)
                if self.checkpoint_dir:
                    path = self._ckpt_path(i)
                    tmp = path + f".tmp{os.getpid()}.npy"
                    np.save(tmp, block)
                    os.replace(tmp, path)
                if progress:
                    progress(i, self.num_blocks)
                results[i] = block

        for index in range(self.num_blocks):
            if self.checkpoint_dir:
                path = self._ckpt_path(index)
                if os.path.exists(path):
                    results[index] = np.load(path)
                    continue
            inflight.append((index, self.dispatch_block(index)))
            drain(max(0, prefetch - 1))
        drain(0)
        return np.concatenate(
            [results[i] for i in range(self.num_blocks)], axis=0)


def _frame_plan(path, window_length: int, step: int):
    from zaftpu.core import frame as _frame

    reader = BlockReader(path, block_samples=1)
    pad_front, _, t = _frame.stft_padding(reader.frames, window_length, step)
    return pad_front, t


def streaming_spectrogram(path, window, step: int, block_frames: int = 4096,
                          checkpoint_dir: str | None = None):
    """Magnitude spectrogram ``(WL/2, T)`` of an arbitrarily long WAV,
    computed in resumable blocks; bins 1..WL/2 (reference convention)."""
    import jax.numpy as jnp

    from zaftpu.core import fft as _fft

    window = np.asarray(window, dtype=np.float32)
    wl = len(window)
    pad_front, t = _frame_plan(path, wl, step)
    window_dev = jnp.asarray(window)

    @zjit
    def block_fn(samples):
        b = (samples.shape[0] - (wl - step)) // step
        half = _fft.windowed_frames_rfft(samples, window_dev, wl, step, b)
        return jnp.abs(half[:, 1:])

    st = StreamingTransform(path, wl, step, pad_front, t, block_fn,
                            block_frames, checkpoint_dir)
    return st.run().T


def streaming_melspectrogram(path, window, step: int, mel_filterbank,
                             block_frames: int = 4096,
                             checkpoint_dir: str | None = None):
    """Mel spectrogram ``(M, T)`` of an arbitrarily long WAV, resumable."""
    import jax.numpy as jnp

    from zaftpu.core import fft as _fft
    from zaftpu.core.policy import operator_matmul
    from zaftpu.features.mel import _as_dense

    window = np.asarray(window, dtype=np.float32)
    wl = len(window)
    pad_front, t = _frame_plan(path, wl, step)
    window_dev = jnp.asarray(window)
    fbank_t = jnp.asarray(_as_dense(mel_filterbank).T.astype(np.float32))

    @zjit
    def block_fn(samples):
        b = (samples.shape[0] - (wl - step)) // step
        half = _fft.windowed_frames_rfft(samples, window_dev, wl, step, b)
        return operator_matmul(jnp.abs(half[:, 1:]), fbank_t)

    st = StreamingTransform(path, wl, step, pad_front, t, block_fn,
                            block_frames, checkpoint_dir)
    return st.run().T


def streaming_mfcc(path, window, step: int, mel_filterbank,
                   number_coefficients: int, block_frames: int = 4096,
                   checkpoint_dir: str | None = None):
    """MFCCs ``(number_coefficients, T)`` of an arbitrarily long WAV,
    resumable — the zaf.py:378-454 chain (power spectrogram -> mel matmul
    -> log(+eps) -> orthonormal DCT-II -> coefficients 1..C) applied per
    frame block."""
    import jax.numpy as jnp

    from zaftpu.core import fft as _fft
    from zaftpu.core.policy import operator_matmul
    from zaftpu.features.mel import _LOG_EPS, _as_dense, dct_ii_ortho_matrix

    window = np.asarray(window, dtype=np.float32)
    wl = len(window)
    pad_front, t = _frame_plan(path, wl, step)
    window_dev = jnp.asarray(window)
    fbank = _as_dense(mel_filterbank).astype(np.float32)
    fbank_t = jnp.asarray(fbank.T)
    dct_t = jnp.asarray(dct_ii_ortho_matrix(fbank.shape[0])
                        .T.astype(np.float32))
    c = int(number_coefficients)

    @zjit
    def block_fn(samples):
        b = (samples.shape[0] - (wl - step)) // step
        half = _fft.windowed_frames_rfft(samples, window_dev, wl, step, b)
        mel = operator_matmul(jnp.abs(half[:, 1:]) ** 2, fbank_t)
        logmel = jnp.log(mel + jnp.asarray(_LOG_EPS, dtype=mel.dtype))
        return operator_matmul(logmel, dct_t)[:, 1:c + 1]

    st = StreamingTransform(path, wl, step, pad_front, t, block_fn,
                            block_frames, checkpoint_dir)
    return st.run().T


def streaming_mdct(path, window, block_frames: int = 4096,
                   checkpoint_dir: str | None = None):
    """MDCT ``(WL/2, T)`` of an arbitrarily long WAV, resumable.

    Reference zaf.py:984-1075 geometry: fixed 50% overlap (hop ``WL/2``),
    ``T = ceil(N/(WL/2)) + 1``, ``WL/2`` zeros prepended. The per-block body
    is the direct-GEMM MDCT operator (window folded with the framing, one
    matmul per block)."""
    import jax.numpy as jnp

    from zaftpu.core import frame as _frame
    from zaftpu.core.policy import real_matmul
    from zaftpu.transforms.mdct import _direct_forward_matrix

    window = np.asarray(window, dtype=np.float32)
    wl = len(window)
    if wl % 2:
        raise ValueError("MDCT window length must be even")
    step = wl // 2
    reader = BlockReader(path, block_samples=1)
    t = int(np.ceil(reader.frames / step)) + 1
    window_dev = jnp.asarray(window)
    matrix = jnp.asarray(_direct_forward_matrix(wl).astype(np.float32))

    @zjit
    def block_fn(samples):
        b = (samples.shape[0] - step) // step
        return real_matmul(
            _frame.windowed_frames(samples, window_dev, wl, step, b), matrix)

    st = StreamingTransform(path, wl, step, step, t, block_fn,
                            block_frames, checkpoint_dir)
    return st.run().T


class StreamingSynthesis:
    """Drive block-wise overlap-add synthesis into a WAV file, resumably.

    The synthesis mirror of :class:`StreamingTransform`: coefficient columns
    are pulled in blocks, each block's time-domain overlap-add is computed on
    device, and the ``overlap`` trailing samples (partial sums reaching into
    the next block) are carried forward — the same halo geometry the sharded
    synthesis transforms exchange between devices, here carried across time
    on one host. Output samples stream to :class:`~zaftpu.io.wavstream.
    StreamingWavWriter`; host and device memory stay bounded regardless of
    signal length.

    Failure recovery: after each block the carry and the output frame count
    are checkpointed (atomic replace); a restarted job truncates the WAV to
    the checkpoint and resumes at the next block.

    Args:
        number_times: total coefficient columns T.
        fetch: ``(first_col, last_col) -> device columns`` for block_fn.
        block_fn: ``(columns) -> time samples (n_cols*step + overlap,)`` —
            the block's internal overlap-add, jitted.
        step: synthesis hop in samples.
        overlap: carried tail length (``window_length - step``).
        trim_front: global samples dropped from the stream head.
        target_len: global output length after trimming.
        writer: open :class:`StreamingWavWriter`.
        block_frames: coefficient columns per block.
        checkpoint_dir: directory for resume state (None = no resume).
    """

    _STATE = "synthesis_state.npz"

    def __init__(self, number_times: int, fetch, block_fn, step: int,
                 overlap: int, trim_front: int, target_len: int, writer,
                 block_frames: int = 4096,
                 checkpoint_dir: str | None = None):
        self.number_times = int(number_times)
        self.fetch = fetch
        self.block_fn = block_fn
        self.step = int(step)
        self.overlap = int(overlap)
        self.trim_front = int(trim_front)
        self.target_len = int(target_len)
        self.writer = writer
        self.block_frames = int(block_frames)
        self.checkpoint_dir = checkpoint_dir
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)

    @property
    def num_blocks(self) -> int:
        return -(-self.number_times // self.block_frames)

    def _state_path(self) -> str:
        return os.path.join(self.checkpoint_dir, self._STATE)

    def _emit(self, chunk: np.ndarray, pos: int) -> None:
        """Write the part of untrimmed-stream samples ``[pos, pos+len)``
        that falls inside the ``[trim_front, trim_front+target_len)``
        window."""
        lo = max(pos, self.trim_front)
        hi = min(pos + chunk.shape[0], self.trim_front + self.target_len)
        if hi > lo:
            self.writer.append(chunk[lo - pos:hi - pos])

    def run(self, progress=None) -> int:
        """All blocks, resuming from the checkpoint; returns frames
        written."""
        first_block = 0
        carry = None
        pos = 0  # untrimmed-stream position of the next emit
        if self.checkpoint_dir and os.path.exists(self._state_path()):
            state = np.load(self._state_path())
            first_block = int(state["next_block"])
            carry = state["carry"]
            pos = int(state["pos"])
            self.writer.truncate(int(state["written"]))
        def dispatch(index):
            # Async device dispatch (no fetch): block k+1 computes on
            # device while the host folds/emits block k.
            first = index * self.block_frames
            last = min(first + self.block_frames, self.number_times)
            return self.block_fn(self.fetch(first, last))

        pending = (dispatch(first_block)
                   if first_block < self.num_blocks else None)
        for index in range(first_block, self.num_blocks):
            first = index * self.block_frames
            last = min(first + self.block_frames, self.number_times)
            dev = pending
            pending = (dispatch(index + 1)
                       if index + 1 < self.num_blocks else None)
            block = np.array(dev)
            if carry is not None and carry.shape[0]:
                block[:self.overlap] += carry.astype(block.dtype)
            if last == self.number_times:  # final block: flush the tail
                emit_n = block.shape[0]
                carry = np.zeros(0, dtype=block.dtype)
            else:
                emit_n = (last - first) * self.step
                carry = block[emit_n:]
            self._emit(block[:emit_n], pos)
            pos += emit_n
            if self.checkpoint_dir:
                tmp = self._state_path() + f".tmp{os.getpid()}.npz"
                np.savez(tmp, next_block=index + 1, carry=carry, pos=pos,
                         written=self.writer.frames_written)
                os.replace(tmp, self._state_path())
            if progress:
                progress(index, self.num_blocks)
        return self.writer.frames_written


def _columns(source, first: int, last: int) -> np.ndarray:
    """Coefficient columns ``[first, last)`` from an array-like ``(F, T)``
    source (in-memory array, ``np.memmap``, ``np.load(mmap_mode=...)``)."""
    return np.ascontiguousarray(np.asarray(source[:, first:last]))


def streaming_istft(audio_stft, window, step: int, out_path,
                    sampling_frequency: int, block_frames: int = 4096,
                    checkpoint_dir: str | None = None) -> int:
    """Inverse STFT streamed to a WAV file, resumable.

    The synthesis mirror of :func:`streaming_spectrogram`: ``audio_stft``
    columns (the full complex ``(WL, T)`` spectrum, reference zaf.py:144-243
    semantics — e.g. a ``np.memmap``/``np.load(..., mmap_mode="r")`` of an
    hour-scale spectrogram) are inverted block-by-block and overlap-added
    across block boundaries via a carried halo; samples append to
    ``out_path`` as float32 WAV. Bit-identical to ``zaftpu.istft`` for 50%
    overlap (two-term output sums are order-independent); for deeper overlap
    the block-boundary accumulation order differs by float rounding only.

    Returns the number of samples written
    (``T*step - window_length + step``)."""
    import jax.numpy as jnp

    from zaftpu.core import fft as _fft
    from zaftpu.core import frame as _frame
    from zaftpu.core import validate as _validate
    from zaftpu.io.wavstream import StreamingWavWriter

    window = np.asarray(_validate.check_window(window))
    wl = len(window)
    step = _validate.check_step(step, wl)
    t = int(audio_stft.shape[1])
    gain = _frame.cola_gain(window, step)
    _validate.check_cola(window, step, gain)

    @zjit
    def block_fn(cols):
        # Bins-major synthesis: major-axis Hermitian fold, COLA gain folded
        # into the inverse operator on the engine path.
        return _fft.synthesis_ola(cols, step, gain)

    def fetch(first, last):
        return jnp.asarray(_columns(audio_stft, first, last))

    resume = bool(checkpoint_dir) and os.path.exists(
        os.path.join(checkpoint_dir, StreamingSynthesis._STATE))
    with StreamingWavWriter(out_path, sampling_frequency,
                            resume=resume) as writer:
        synth = StreamingSynthesis(
            t, fetch, block_fn, step, wl - step, trim_front=wl - step,
            target_len=t * step - wl + step, writer=writer,
            block_frames=block_frames, checkpoint_dir=checkpoint_dir)
        return synth.run()


def streaming_imdct(audio_mdct, window, out_path, sampling_frequency: int,
                    block_frames: int = 4096,
                    checkpoint_dir: str | None = None) -> int:
    """Inverse MDCT (TDAC) streamed to a WAV file, resumable.

    ``audio_mdct`` is the ``(F, T)`` coefficient matrix (reference
    zaf.py:1078-1184 semantics); per block the folded inverse operator
    (window baked into its columns) runs one GEMM and the TDAC overlap-add,
    carrying ``F`` halo samples between blocks. TDAC sums are two-term, so
    the result is bit-identical to ``zaftpu.imdct``. Returns samples written
    (``F*(T+1) - 2F - 1``)."""
    import jax.numpy as jnp

    from zaftpu.core import frame as _frame
    from zaftpu.core.policy import real_matmul
    from zaftpu.io.wavstream import StreamingWavWriter
    from zaftpu.transforms.mdct import (_direct_inverse_windowed_matrix,
                                        _host_window_bytes)

    window = np.asarray(window)
    f = int(audio_mdct.shape[0])
    if len(window) != 2 * f:
        raise ValueError(f"window length must be 2*number_frequencies = "
                         f"{2 * f}, got {len(window)}")
    t = int(audio_mdct.shape[1])
    dtype = np.float64 if np.asarray(audio_mdct[:1, :1]).dtype == np.float64 \
        else np.float32
    matrix = jnp.asarray(
        _direct_inverse_windowed_matrix(f, _host_window_bytes(window))
        .astype(dtype))

    @zjit
    def block_fn(cols):
        frames = real_matmul(cols, matrix)  # (b, 2F)
        return _frame.overlap_add(frames, f)

    def fetch(first, last):
        return jnp.asarray(_columns(audio_mdct, first, last).T.astype(dtype))

    resume = bool(checkpoint_dir) and os.path.exists(
        os.path.join(checkpoint_dir, StreamingSynthesis._STATE))
    with StreamingWavWriter(out_path, sampling_frequency,
                            resume=resume) as writer:
        synth = StreamingSynthesis(
            t, fetch, block_fn, f, overlap=f, trim_front=f,
            target_len=f * (t + 1) - 2 * f - 1, writer=writer,
            block_frames=block_frames, checkpoint_dir=checkpoint_dir)
        return synth.run()


def streaming_cqtspectrogram(path, sampling_frequency, time_resolution,
                             cqt_kernel, block_frames: int = 256,
                             checkpoint_dir: str | None = None):
    """CQT spectrogram ``(F, T)`` of an arbitrarily long WAV, resumable.

    Frame geometry follows reference zaf.py:602-620: hop
    ``round(sr/time_resolution)``, each frame reaching ``fft_length``
    samples (the streaming "window length"), asymmetric centering pad.
    The per-block body is the fused time-domain kernel matmul
    (:func:`zaftpu.transforms.cqt._blocked_matmul_impl`), so no 32k FFT is
    ever compiled."""
    import jax.numpy as jnp

    from zaftpu.core import policy as _policy
    from zaftpu.io.stream import BlockReader
    from zaftpu.transforms import cqt as _cqt

    kern = _cqt._as_kernel(cqt_kernel)
    step = round(float(sampling_frequency) / float(time_resolution))
    fft_length = kern.fft_length
    reader = BlockReader(path, block_samples=1)
    t = reader.frames // step
    if t < 1:
        raise ValueError("signal shorter than one CQT hop")
    pad_front = int(np.ceil((fft_length - step) / 2))
    kdtype = _policy.operator_dtype(np.float32)
    m_real, m_imag = _cqt._device_time_kernel(kern, kdtype)

    @zjit
    def _block_jit(samples, mr, mi):
        # Kernel operators ride as traced args, not 37 MB jaxpr constants.
        b = (samples.shape[0] - (fft_length - step)) // step
        need = _cqt._blocked_needed(b, step, fft_length)
        padded = jnp.pad(samples, (0, max(0, need - samples.shape[0])))
        return _cqt._blocked_matmul_impl(padded, mr, mi, step, fft_length,
                                         b, min(b, block_frames))

    def block_fn(samples):
        return _block_jit(samples, m_real, m_imag)

    st = StreamingTransform(path, fft_length, step, pad_front, t, block_fn,
                            block_frames, checkpoint_dir)
    return st.run().T
