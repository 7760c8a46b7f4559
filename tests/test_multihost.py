"""Real multi-process distributed execution (jax.distributed + Gloo CPU
collectives as the no-pod proxy; SURVEY.md section 2f comm-backend row).

Spawns N local processes, each with its own JAX runtime and 8/N virtual
CPU devices, connected through a coordinator.  Every process feeds only
its own channel slab (multihost.host_local_channels +
jax.make_array_from_process_local_data) and the sharded step's time-axis
halos cross the process boundary.  Each worker asserts its output shards
byte-identical to the unsharded single-device chain
(tools/multihost_worker.py --check).
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env() -> dict:
    """Subprocess env: CPU backend, the repo on the path and nothing
    else inherited that configures JAX (no forced device count, no
    platform pin), so the worker sets up the distributed CPU runtime."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run_job(num_processes: int, devices_per_proc: int, extra: list[str],
             timeout: float = 600.0) -> list[str]:
    port = _free_port()
    env = _worker_env()
    procs = []
    for pid in range(num_processes):
        cmd = [sys.executable, WORKER,
               "--process-id", str(pid),
               "--num-processes", str(num_processes),
               "--coordinator", f"127.0.0.1:{port}",
               "--cpu-proxy-devices", str(devices_per_proc)] + extra
        procs.append(subprocess.Popen(cmd, env=env, cwd=REPO,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    failed = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"worker {pid} timed out after {timeout}s")
        outs.append(out)
        if p.returncode != 0:
            failed.append((pid, p.returncode, out))
    assert not failed, "\n\n".join(
        f"worker {pid} exited {rc}:\n{out[-3000:]}" for pid, rc, out in failed)
    return outs


def test_two_process_byte_identical():
    outs = _run_job(2, 4, ["--channels", "4", "--blocks", "3", "--check"])
    for pid, out in enumerate(outs):
        assert f"[proc {pid}] CHECK OK" in out, out[-2000:]
        assert f"[proc {pid}] PASS" in out


def test_four_process_byte_identical():
    """4 processes x 2 devices: 4 channel shards x 2 time shards; halos and
    the channel axis both cross process boundaries."""
    outs = _run_job(4, 2, ["--channels", "8", "--blocks", "2", "--check"])
    for pid, out in enumerate(outs):
        assert f"[proc {pid}] CHECK OK" in out, out[-2000:]
        assert f"[proc {pid}] PASS" in out
