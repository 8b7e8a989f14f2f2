"""Seeded test audio, made on the device.

The signal is the repository's long-standing test audio: four tones with a
slow 5 Hz vibrato, amplitudes 0.3, 0.2, 0.15 and 0.1, plus white noise 30
dB down (0.03 standard deviation). Frequencies are whole hertz, so each
tone's phase is computed exactly in integers from the absolute sample
index, and a signal of any length keeps its tones in float32.

A signal is a sequence of pieces of equal length. Piece ``p`` starts at
sample ``p * length``; its noise is drawn from the seed's key folded with
``p``. Everything follows from the seed: the same seed gives the same
samples, on any device.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

AMPLITUDES = (0.3, 0.2, 0.15, 0.1)
NOISE = 0.03
VIBRATO_HZ = 5


def rng_for(seed: int) -> np.random.Generator:
    """NumPy's generator for any whole-number seed (negative or past 64
    bits included)."""
    return np.random.default_rng(int(seed) % (1 << 64))


@dataclasses.dataclass(frozen=True)
class ToneMix:
    """The seeded parameters of one signal."""

    sampling_frequency: int
    frequencies: tuple      # whole hertz, 80..4000
    phases: tuple           # radians
    noise_key: int          # 31-bit key for jax.random

    @classmethod
    def from_seed(cls, seed: int, sampling_frequency: int) -> "ToneMix":
        rng = rng_for(seed)
        top = min(4000, sampling_frequency // 2 - 1)
        freqs = rng.integers(80, top + 1, size=len(AMPLITUDES))
        phases = rng.uniform(0.0, 2.0 * np.pi, size=len(AMPLITUDES))
        key = int(rng.integers(0, 1 << 31))
        return cls(int(sampling_frequency), tuple(int(f) for f in freqs),
                   tuple(float(p) for p in phases), key)


def _piece(mix: ToneMix, index, length: int):
    """Samples ``[index*length, (index+1)*length)`` as float32 (traceable;
    ``index`` may be a traced int32 scalar)."""
    import jax
    import jax.numpy as jnp

    sr = mix.sampling_frequency
    n = index * length + jnp.arange(length, dtype=jnp.int32)
    m = n % sr
    two_pi = np.float32(2.0 * np.pi)
    key = jax.random.fold_in(jax.random.key(mix.noise_key), index)
    out = np.float32(NOISE) * jax.random.normal(key, (length,), jnp.float32)
    vibrato = jnp.sin(two_pi * ((m * VIBRATO_HZ) % sr).astype(jnp.float32)
                      / np.float32(sr))
    for amp, freq, phase in zip(AMPLITUDES, mix.frequencies, mix.phases):
        carrier = two_pi * ((m * freq) % sr).astype(jnp.float32) / np.float32(sr)
        out = out + np.float32(amp) * jnp.sin(
            carrier + np.float32(0.002 * freq) * vibrato + np.float32(phase))
    return out


@lru_cache(maxsize=16)
def _pieces_program(mix: ToneMix, count: int, length: int):
    import jax
    import jax.numpy as jnp

    make = jax.vmap(lambda index: _piece(mix, index, length))
    return jax.jit(lambda: make(jnp.arange(count, dtype=jnp.int32)))


def device_block(mix: ToneMix, count: int, length: int):
    """Pieces ``0 .. count - 1`` of ``length`` samples as one ``(count,
    length)`` float32 array on the default device, made in one jitted
    call."""
    return _pieces_program(mix, count, length)()


def device_pieces(mix: ToneMix, count: int, length: int):
    """The pieces of :func:`device_block` as separate arrays."""
    block = device_block(mix, count, length)
    return [block[i] for i in range(count)]


def sharded_signal(mix: ToneMix, mesh, axis_name: str, length: int):
    """One signal of ``length`` samples, sharded in equal contiguous pieces
    over ``mesh``'s ``axis_name``; each device makes its own piece."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    shards = mesh.shape[axis_name]
    if length % shards:
        raise ValueError(f"{length} samples do not split into {shards} "
                         "equal pieces")
    local = length // shards

    def body(index):
        return _piece(mix, index[0], local)

    make = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P(axis_name),
                                 out_specs=P(axis_name)))
    index = jax.device_put(jnp.arange(shards, dtype=jnp.int32),
                           NamedSharding(mesh, P(axis_name)))
    return make(index)


def host_clips(mix: ToneMix, count: int, length: int) -> list:
    """``count`` clips as float32 NumPy arrays on the host, made on the
    device in one call and copied back once."""
    import jax

    block = np.asarray(jax.device_get(device_block(mix, count, length)))
    return list(block)
