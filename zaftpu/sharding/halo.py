"""Halo exchange primitives for frame-block sharding.

Every transform in the framework is frame-local with bounded overlap
(``window_length - step`` for STFT/MDCT analysis and synthesis; up to
``fft_length - step`` for CQT). Sharding a long signal by contiguous frame
blocks therefore needs exactly two one-hop neighbor exchanges
(SURVEY.md §5 "long-context"):

* **analysis**: each shard pulls ``halo`` samples from the *start* of its
  right neighbor's block so its last frames are complete
  (:func:`pull_from_right`);
* **synthesis** (overlap-add): each shard's local OLA produces ``halo``
  boundary samples that belong to the right neighbor's region; they are
  pushed right and summed (:func:`push_right_sum`).

Both are ``jax.lax.ppermute`` hops on the mesh's frame axis — neighbour
traffic over the device interconnect (NVLink on a GPU host), no
all-gathers. Edge devices receive zeros, which is exactly
correct because callers arrange the global padding so everything beyond the
sharded body is zero. When the halo exceeds one block (tiny shards, CQT's
~31k-sample reach) the pull escalates to multiple hops automatically.

All functions operate on the LAST axis (leading axes are batch) and must be
called inside ``shard_map`` with ``axis_name`` bound.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _zeros_tail(block: jnp.ndarray, length: int) -> jnp.ndarray:
    return jnp.zeros(block.shape[:-1] + (length,), block.dtype)


def pull_from_right(block: jnp.ndarray, halo: int, axis_name: str):
    """Append the first ``halo`` samples of the right neighbor(s)' block.

    ``block``: this shard's ``(..., local_len)`` sample block. Returns
    ``(..., local_len + halo)``. Shards past the right edge contribute
    zeros — callers guarantee the true continuation is zero padding.
    """
    if halo == 0:
        return block
    n = jax.lax.axis_size(axis_name)
    block_len = block.shape[-1]
    if n == 1:
        return jnp.concatenate([block, _zeros_tail(block, halo)], axis=-1)
    hops = -(-halo // block_len)
    out = [block]
    remaining = halo
    for h in range(1, hops + 1):
        piece = jax.lax.ppermute(
            block, axis_name, [(i, i - h) for i in range(h, n)])
        take = min(block_len, remaining)
        out.append(piece[..., :take])
        remaining -= take
    if remaining > 0:
        out.append(_zeros_tail(block, remaining))
    return jnp.concatenate(out, axis=-1)


def push_right_sum(body: jnp.ndarray, tail: jnp.ndarray, axis_name: str):
    """Send ``tail`` to the right neighbor(s); add the spill received from
    the left onto the start of ``body`` (last axis).

    This is the overlap-add boundary exchange: shard i's local OLA spills
    ``tail.shape[-1]`` samples into the territory of shard i+1 (and, when the
    spill is longer than one body — large overlap on tiny shards — into
    i+2, ...): chunk c of the tail lands at the start of shard i+1+c. Edge
    shards' spill beyond the last body is dropped, matching the global-trim
    semantics (callers size the body so everything trimmed is zero-region).
    Shard 0 receives zeros.
    """
    halo = tail.shape[-1]
    if halo == 0:
        return body
    n = jax.lax.axis_size(axis_name)
    if n == 1:
        return body
    body_len = body.shape[-1]
    hops = -(-halo // body_len)
    for c in range(hops):
        piece = tail[..., c * body_len:(c + 1) * body_len]
        if n - 1 - c <= 0:
            break
        received = jax.lax.ppermute(
            piece, axis_name, [(i, i + 1 + c) for i in range(n - 1 - c)])
        body = body.at[..., :piece.shape[-1]].add(received)
    return body
