"""Cross-process mesh regression: runs scripts/multihost_sim.py (two JAX
processes x 4 virtual CPU devices forming one 8-device mesh over
``jax.distributed.initialize``) as a subprocess and requires PASS.

This is the only gate on ``initialize_distributed``/cross-process halo
exchange (the in-process suite shares one runtime, so it can never catch a
regression there). Skips when no loopback port can be bound or the
coordinator service cannot start in this environment (sandboxes without
localhost networking).
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM = os.path.join(REPO, "scripts", "multihost_sim.py")

_COORDINATOR_ENV_FAILURES = (
    "Failed to bind", "bind failed", "UNAVAILABLE", "DEADLINE_EXCEEDED",
    "Connection refused", "coordinator",
)


def _free_port():
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]
    except OSError:
        pytest.skip("cannot bind a loopback port in this environment")


def test_two_process_mesh_end_to_end():
    env = dict(os.environ, MULTIHOST_PORT=str(_free_port()))
    # The workers pin their own platform/device count; drop the suite's
    # 8-device flag so the appended per-worker 4-device flag is unambiguous.
    env.pop("XLA_FLAGS", None)
    try:
        proc = subprocess.run(
            [sys.executable, SIM], env=env, cwd=REPO,
            capture_output=True, text=True, timeout=390)
    except subprocess.TimeoutExpired:
        pytest.skip("multihost sim timed out — coordinator likely blocked "
                    "in this environment")
    out = proc.stdout + proc.stderr
    # Skip ONLY on startup-phase failures: once a worker prints its "mesh
    # ready" sentinel the coordinator and mesh are up, so a later error
    # mentioning e.g. "coordinator" (an assertion message, a teardown
    # warning) must FAIL, not skip.
    started = "mesh ready" in proc.stdout
    if (proc.returncode != 0 and not started
            and any(m in out for m in _COORDINATOR_ENV_FAILURES)):
        pytest.skip(f"distributed coordinator unavailable: {out[-400:]}")
    assert proc.returncode == 0, out[-2000:]
    assert "multihost simulation: PASS" in proc.stdout
    # Both processes verified their addressable shards.
    assert proc.stdout.count("shards verified") == 2
