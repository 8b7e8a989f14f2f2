"""zaftpu — audio signal analysis as JAX programs.

A JAX/XLA implementation of the full capability set of Zaf-Python:
short-time Fourier analysis, mel features, constant-Q transforms,
trigonometric transforms (DCT/DST I-IV), MDCT/IMDCT codec transforms, WAV
I/O, and display helpers — redesigned for an accelerator rather than ported.
It runs on an NVIDIA GPU (the H100 is the measured target), with the CPU
backend as the float64 parity oracle:

* batched, frames-major ``(num_frames, window_length)`` layout so every FFT is
  contiguous and batched (the reference's ``(WL, T)`` layout with a strided
  axis-0 FFT collapses to 88 frames/s at 1-hour scale, see BASELINE.md);
* real-input ``rfft`` fast paths internally, with the reference's full-complex
  spectrum convention reconstructed at the API boundary for drop-in parity;
* filterbank/DCT applications as dense GEMMs instead of per-call densified
  CSR products (reference zaf.py:373,445);
* long signals shard over the frame axis of a ``jax.sharding.Mesh`` with
  window-overlap halo exchange via ``shard_map`` + ``ppermute`` (analysis) and
  boundary-sum exchange (overlap-add synthesis) — see ``zaftpu.sharding``;
* precomputed operators (mel filterbank, CQT kernel) built once on host in
  float64 for exact parity with the reference's construction math, then cached
  and applied on-device.

Public API mirrors the reference's 20 functions with identical semantics;
shapes and values match the reference within floating-point tolerance
(float64 mode is bit-faithful up to rounding).
"""

from zaftpu.transforms.stft import stft, istft, spectrogram
from zaftpu.transforms.griffinlim import griffin_lim
from zaftpu.transforms.dct import dct, dst
from zaftpu.transforms.mdct import mdct, imdct
from zaftpu.transforms.cqt import cqtkernel, cqtspectrogram, cqtchromagram
from zaftpu.features.mel import melfilterbank, melspectrogram, mfcc
from zaftpu.io.wav import wavread, wavwrite
from zaftpu.viz.display import (
    sigplot,
    specshow,
    melspecshow,
    mfccshow,
    cqtspecshow,
    cqtchromshow,
)
from zaftpu.config import (StftConfig, MelConfig, CqtConfig, MdctConfig,
                           DispatchConfig)
from zaftpu.core.policy import compute_dtype

__version__ = "0.1.0"

#: The bf16 GEMM fast path (``with zaftpu.compute_dtype("bfloat16")`` or
#: ``ZAFTPU_DTYPE=bfloat16``) is available — see zaftpu/core/policy.py.
BF16_SUPPORTED = True

__all__ = [
    "stft",
    "istft",
    "spectrogram",
    "griffin_lim",
    "melfilterbank",
    "melspectrogram",
    "mfcc",
    "cqtkernel",
    "cqtspectrogram",
    "cqtchromagram",
    "dct",
    "dst",
    "mdct",
    "imdct",
    "wavread",
    "wavwrite",
    "sigplot",
    "specshow",
    "melspecshow",
    "mfccshow",
    "cqtspecshow",
    "cqtchromshow",
    "StftConfig",
    "MelConfig",
    "CqtConfig",
    "MdctConfig",
    "DispatchConfig",
    "compute_dtype",
]
