"""Host-side feed-path budget: ns per complex sample for every step the
GPU's host executes at the flagship geometry.

This tool times each stage of the host feed path in isolation on THIS
host and reports:

  * ns/sample and the implied standalone Msps per stage;
  * the aggregate host Msps (serial composition of the per-block
    stages, as `runtime.StreamEngine._run_chain.process` runs them);
  * the device rate at which the host becomes the bottleneck, and the
    block size sensitivity (per-block constant costs amortize).

`device_put`/readback are measured too: host<->device copies over the
host's PCIe link to whatever device JAX reports.

    python tools/host_budget.py [--channels N] [--block N] [--no-device]

Prints one JSON line per stage plus a summary line; record the table
in PERF.md with the card and host it was measured on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _best(f, reps: int = 7) -> float:
    """Best-of-reps wall seconds for f() (min filters scheduler noise)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        f()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--block", type=int, default=1 << 18)
    ap.add_argument("--no-device", action="store_true",
                    help="skip device_put/readback")
    opts = ap.parse_args()
    ch, n = opts.channels, opts.block
    samples = ch * n                       # complex samples per step
    bpf = 4                                # cs16 wire bytes/frame
    blk = n * bpf

    from iq_tool_tpu import native
    native.ensure_built()

    rng = np.random.default_rng(0)
    wire_rows = [rng.integers(-2**15, 2**15, n * 2).astype(np.int16).tobytes()
                 for _ in range(ch)]
    rows_np = None

    results = {}

    def report(stage, secs, note=""):
        nsps = secs / samples * 1e9
        msps = samples / secs / 1e6
        results[stage] = nsps
        print(json.dumps({"stage": stage, "ns_per_sample": round(nsps, 3),
                          "standalone_Msps": round(msps, 1),
                          **({"note": note} if note else {})}), flush=True)

    # 1. file read at block granularity (page-cache hot: upper bound of
    #    what a local NVMe/SDR DMA delivery into user space costs)
    with tempfile.NamedTemporaryFile(delete=False) as f:
        path = f.name
        for r in wire_rows:
            f.write(r)
    fd = open(path, "rb", buffering=0)

    def read_all():
        fd.seek(0)
        for _ in range(ch):
            fd.read(blk)
    report("file_read", _best(read_all), "page-cache hot")
    fd.close()
    os.unlink(path)

    # 2. native SPSC ring write+read round trip (the SDR ingest path)
    ring = None
    if native.available():
        ring = native.NativeRingBuffer(blk * 4)

        def ring_rt():
            for r in wire_rows:
                ring.write(r)
                ring.read(blk)
        report("native_ring_write+read", _best(ring_rt))
    else:
        print(json.dumps({"stage": "native_ring_write+read",
                          "error": "native library unavailable"}), flush=True)

    # 3. bytes -> (ch, n*2) int16 wire array (runtime.process's pack)
    def pack():
        nonlocal rows_np
        rows_np = np.stack([np.frombuffer(r, np.int16) for r in wire_rows])
    report("frombuffer+stack", _best(pack))

    # 4. writer-side: int16 device array -> bytes (tobytes of a C-contig
    #    array is one memcpy; sinks write memoryviews of it)
    out_arr = rng.integers(-2**15, 2**15, (ch, n * 2)).astype(np.int16)
    report("out_tobytes", _best(lambda: out_arr.tobytes()))

    # 5. sink write (tmpfs file: upper bound for a local NVMe writer)
    with tempfile.NamedTemporaryFile(delete=False) as f:
        wpath = f.name
    wfd = open(wpath, "wb", buffering=0)
    data = out_arr.tobytes()

    def sink():
        wfd.seek(0)
        wfd.write(data)
    report("sink_write", _best(sink), "tmpfs")
    wfd.close()
    os.unlink(wpath)

    # 6/7. device transfer
    if not opts.no_device:
        import jax
        dev = jax.device_put(rows_np)     # warm
        dev.block_until_ready()
        kind = jax.devices()[0].device_kind
        report("device_put", _best(lambda: jax.device_put(
            rows_np).block_until_ready(), reps=3), kind)
        report("device_get", _best(lambda: np.asarray(dev), reps=3), kind)

    host_stages = ["file_read", "frombuffer+stack", "out_tobytes",
                   "sink_write"]
    if ring is not None:
        host_stages.insert(1, "native_ring_write+read")
    total_ns = sum(results[s] for s in host_stages)
    host_msps = 1e3 / total_ns
    print(json.dumps({
        "summary": "host-only serial path (no device transfer)",
        "stages": host_stages,
        "ns_per_sample": round(total_ns, 3),
        "host_Msps": round(host_msps, 1),
        "channels": ch, "block": n,
        "note": ("host feed becomes the bottleneck when the device rate "
                 f"exceeds ~{host_msps:.0f} Msps aggregate; reader/writer "
                 "threads overlap ~half of this with device compute"),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
