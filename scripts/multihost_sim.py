"""Two-process multi-host validation of the sharded transforms (CPU sim).

Launches two JAX processes (4 virtual CPU devices each) that form one
8-device mesh via ``jax.distributed.initialize`` and run the frame-sharded
STFT -> ISTFT pipeline across process boundaries — the halo ``ppermute``
hops cross processes exactly as they would cross hosts on a pod slice. Each
process checks its addressable shards against the single-device reference.

Run: ``python scripts/multihost_sim.py`` (spawns the workers itself).
``MULTIHOST_PORT`` overrides the coordinator port (default 9911) so
concurrent runs — e.g. the pytest wrapper in tests/test_multihost.py —
don't collide.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = int(os.environ.get("MULTIHOST_PORT", "9911"))


def worker(process_id: int) -> None:
    sys.path.insert(0, REPO)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{PORT}",
                               num_processes=2, process_id=process_id)
    import numpy as np

    import zaftpu
    from zaftpu.core.windows import hamming
    from zaftpu.sharding import istft_sharded, make_mesh, stft_sharded

    devices = jax.devices()
    assert len(devices) == 8, devices
    mesh = make_mesh(len(devices))
    # Startup-phase sentinel: once this prints, the coordinator handshake
    # and mesh construction succeeded — any later failure is a REAL
    # regression, and the pytest wrapper must not skip on it
    # (tests/test_multihost.py).
    print(f"process {process_id}: mesh ready", flush=True)
    win = hamming(512)
    sig = np.sin(0.01 * np.arange(8 * 6 * 256)) * 0.5

    spec = stft_sharded(sig, win, 256, mesh)
    rec = istft_sharded(spec, win, 256, mesh)

    ref_spec = np.asarray(zaftpu.stft(sig, win, 256))
    ref_rec = np.asarray(zaftpu.istft(ref_spec, win, 256))

    for shard in rec.addressable_shards:
        piece = np.asarray(jax.device_get(shard.data))
        want = ref_rec[shard.index]
        np.testing.assert_allclose(piece, want, atol=1e-12)
    for shard in spec.addressable_shards:
        piece = np.asarray(jax.device_get(shard.data))
        np.testing.assert_allclose(piece, ref_spec[shard.index], atol=1e-12)
    print(f"process {process_id}: "
          f"{len(rec.addressable_shards)} shards verified against the "
          f"single-device reference", flush=True)


def main() -> int:
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(pid)], cwd=REPO)
             for pid in (0, 1)]
    rc = 0
    for p in procs:
        rc |= p.wait()
    print("multihost simulation:", "PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]))
    else:
        sys.exit(main())
