"""Would one card hold a cell's whole request? Compile the one-card
programs at the cell's size, without running them, and print what XLA
says they need (``memory_analysis()``), beside the card's memory.

    python3 benchmark/one_card.py --seconds 43200

Made for ``zaf44k.roundtrip.12h.4chip``: ``zaftpu.stft`` and then
``zaftpu.istft`` of one signal at Zaf's 44.1 kHz settings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def analysis(compiled) -> dict:
    mem = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    out = {k: int(getattr(mem, k)) for k in keys if hasattr(mem, k)}
    out["total_bytes"] = (out.get("argument_size_in_bytes", 0)
                          + out.get("output_size_in_bytes", 0)
                          + out.get("temp_size_in_bytes", 0)
                          - out.get("alias_size_in_bytes", 0))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seconds", type=int, default=43200)
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from benchmark import device, reference
    from zaftpu.config import DispatchConfig
    from zaftpu.core.frame import cola_gain
    from zaftpu.transforms import stft as stft_mod

    devices = device.require_gpus(1)
    win = reference.window({"window": "hamming", "window_length": 2048})
    sr, step = 44100, 1024
    n = args.seconds * sr
    t = reference.stft_frames(n, win.shape[0], step)
    snap = DispatchConfig.current()
    x = jax.ShapeDtypeStruct((n,), jnp.float32)
    w = jax.ShapeDtypeStruct(win.shape, jnp.float32)
    spec = jax.ShapeDtypeStruct((win.shape[0], t), jnp.complex64)
    forward = stft_mod._stft_full._zjit.lower(
        x, w, step, _dispatch=snap).compile()
    inverse = stft_mod._istft_core._zjit.lower(
        spec, step, cola_gain(np.asarray(win), step), _dispatch=snap).compile()
    stats = devices[0].memory_stats() or {}
    print(json.dumps({
        "samples": n, "frames": t,
        "stft": analysis(forward), "istft": analysis(inverse),
        "card_bytes_limit": stats.get("bytes_limit"),
        "card": device.card_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
