"""What the card reaches, measured beside a traced run: a large copy and a
large bf16 matrix product, each timed on the host clock over enough
repetitions to span a few hundred milliseconds. The shares in the per-layer
metrics are against the data sheet; these say how much of it the card
delivers in the same call."""

from __future__ import annotations

import time

COPY_ELEMENTS = 1 << 30          # 4 GiB of float32 read, 4 GiB written
COPY_REPS = 128
MATMUL_SIZE = 8192
MATMUL_REPS = 200


def _timed(fn, args, reps: int) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    start = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - start) / reps


def run(device) -> dict:
    import jax
    import jax.numpy as jnp

    key = jax.random.key(0)
    x = jax.device_put(jnp.zeros(COPY_ELEMENTS, jnp.float32), device)
    copy_s = _timed(jax.jit(lambda a: a + 1.0), (x,), COPY_REPS)
    del x
    a, b = (jax.device_put(jax.random.normal(k, (MATMUL_SIZE, MATMUL_SIZE),
                                             jnp.bfloat16), device)
            for k in jax.random.split(key))
    mm_s = _timed(jax.jit(lambda p, q: jnp.matmul(
        p, q, preferred_element_type=jnp.float32)), (a, b), MATMUL_REPS)
    return {"copy_bytes_per_s": 8.0 * COPY_ELEMENTS / copy_s,
            "copy_s": copy_s,
            "bf16_matmul_flops_per_s": 2.0 * MATMUL_SIZE ** 3 / mm_s,
            "bf16_matmul_s": mm_s}
