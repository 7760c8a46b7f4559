"""One process of a multi-host sharded-chain job (CPU proxy or GPU hosts).

Exercises the real multi-host path end to end (SURVEY.md section 2f
"communication backend" row):

  multihost.initialize  ->  jax.distributed over a coordinator
  multihost.global_mesh ->  (channel, time) mesh spanning every process
  multihost.host_local_channels -> which channel slab THIS process feeds
  jax.make_array_from_process_local_data -> host-local feeding, no
      cross-process data redistribution in the steady state
  ShardedChain.step     ->  shard_map with ppermute halos; the time-axis
      halos cross the process boundary via Gloo (CPU proxy) / NCCL (GPUs)

Run one process per host (tests/test_multihost.py spawns them locally):

    JAX_PLATFORMS=cpu python tools/multihost_worker.py \
        --process-id 0 --num-processes 2 --coordinator 127.0.0.1:9876 \
        --cpu-proxy-devices 4 --channels 4 --blocks 4 --check

In --check mode every process recomputes the full-stream reference with
the UNSHARDED single-device Chain and asserts its own addressable output
shards are byte-identical (the config below avoids the DC IIR, whose
cross-shard float re-association is only SNR-equal; see
tests/test_sharded.py::test_sharded_without_dc_is_exact).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_config(channels: int, target_block: int):
    from iq_tool_tpu.ops.fir_design import FilterRequest
    from iq_tool_tpu.pipeline.chain import ChainConfig
    # full chain minus DC (exactness; see module docstring): convert ->
    # NCO -> FIR low-pass -> rational resample -> AGC -> convert
    return ChainConfig(
        input_format="cs16", output_format="cs16",
        input_rate=2_048_000.0, target_rate=1_488_375.0,
        channels=channels,
        freq_shift_pre_hz=150_000.0,
        filters=[FilterRequest("lowpass", 400_000.0)],
        agc_profile="local",
        target_block=target_block,
    )


def assemble_local(out):
    """Assemble this process's addressable shards of a (C, L) global array
    into (local_channels, local_L) plus the first global channel index."""
    import numpy as np
    shards = sorted(out.addressable_shards,
                    key=lambda s: (s.index[0].start or 0, s.index[1].start or 0))
    by_ch: dict[int, list] = {}
    for s in shards:
        by_ch.setdefault(s.index[0].start or 0, []).append(np.asarray(s.data))
    ch0 = min(by_ch)
    rows = [np.concatenate(by_ch[k], axis=-1) for k in sorted(by_ch)]
    return np.concatenate(rows, axis=0), ch0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", default="127.0.0.1:9876")
    ap.add_argument("--cpu-proxy-devices", type=int, default=None,
                    help="virtual CPU devices per process (test proxy)")
    ap.add_argument("--channels", type=int, default=4)
    ap.add_argument("--channel-shards", type=int, default=None,
                    help="default: one channel shard per process")
    ap.add_argument("--time-shards", type=int, default=None)
    ap.add_argument("--target-block", type=int, default=2048)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--check", action="store_true",
                    help="verify vs the unsharded single-device chain")
    ap.add_argument("--bench", action="store_true",
                    help="print Msamples/s for the steady-state loop")
    args = ap.parse_args()

    from iq_tool_tpu.parallel import multihost
    multihost.initialize(args.coordinator, args.num_processes,
                         args.process_id,
                         cpu_proxy_devices=args.cpu_proxy_devices)

    import jax
    import numpy as np
    pid = jax.process_index()
    assert pid == args.process_id, (pid, args.process_id)
    n_dev = jax.device_count()

    c_shards = args.channel_shards or args.num_processes
    t_shards = args.time_shards or (n_dev // c_shards)
    mesh = multihost.global_mesh(channel_shards=c_shards,
                                 time_shards=t_shards)

    from iq_tool_tpu.parallel.sharded import ShardedChain
    cfg = build_config(args.channels, args.target_block)
    sc = ShardedChain(cfg, mesh)
    first_ch, n_ch = multihost.host_local_channels(sc)
    print(f"[proc {pid}] devices={n_dev} mesh={c_shards}x{t_shards} "
          f"feeds channels [{first_ch}, {first_ch + n_ch})", flush=True)

    # deterministic global input; every process generates the same stream
    # and slices ITS slab (stand-in for per-host file readers)
    rng = np.random.default_rng(20260817)
    items = sc.local.fmt_in.items_per_frame
    raws_global = [rng.integers(-2 ** 14, 2 ** 14,
                                (args.channels, sc.n_in * items))
                   .astype(np.int16) for _ in range(args.blocks)]

    from jax.sharding import NamedSharding, PartitionSpec as P
    in_sharding = NamedSharding(mesh, P("channel", "time"))

    def feed(raw_global):
        local = raw_global[first_ch:first_ch + n_ch]
        return jax.make_array_from_process_local_data(
            in_sharding, local, raw_global.shape)

    carry = sc.init_carry()
    outs_local = []
    for raw in raws_global:
        carry, out = sc.step(carry, feed(raw), np.bool_(False))
        outs_local.append(assemble_local(out))
    got = np.concatenate([o for o, _ in outs_local], axis=-1)
    ch0 = outs_local[0][1]
    assert ch0 == first_ch, (ch0, first_ch)

    if args.bench:
        # steady-state timing: run the same blocks again, timed
        n_rep = 8
        carry, out = sc.step(carry, feed(raws_global[0]), np.bool_(False))
        _ = assemble_local(out)                         # sync
        t0 = time.monotonic()
        for i in range(n_rep):
            carry, out = sc.step(carry, feed(raws_global[i % args.blocks]),
                                 np.bool_(False))
        _ = assemble_local(out)                         # sync
        dt = time.monotonic() - t0
        msps = args.channels * sc.n_in * n_rep / dt / 1e6
        print(f"[proc {pid}] BENCH {msps:.3f} Msamples/s aggregate "
              f"({n_rep} steps, {dt * 1e3:.1f} ms)", flush=True)

    if args.check:
        from iq_tool_tpu.pipeline.chain import Chain, ChainConfig
        single = Chain(ChainConfig(**{**cfg.__dict__, "channels": n_ch,
                                      "target_block":
                                          sc.local.cfg.target_block}))
        assert sc.n_in == t_shards * single.n_in
        carry1 = single.init_carry()
        outs = []
        for raw in raws_global:
            slab = raw[first_ch:first_ch + n_ch]
            for j in range(t_shards):
                sub = slab[:, j * single.n_in * items:
                           (j + 1) * single.n_in * items]
                carry1, out = single.step(carry1, sub, np.bool_(False))
                outs.append(np.asarray(jax.device_get(out)))
        want = np.concatenate(outs, axis=-1)
        if got.shape != want.shape or not np.array_equal(got, want):
            diff = (got.astype(np.float64) - want.astype(np.float64))
            print(f"[proc {pid}] CHECK FAILED max|diff|="
                  f"{np.abs(diff).max()}", flush=True)
            return 1
        print(f"[proc {pid}] CHECK OK: {got.shape} byte-identical to the "
              "single-device chain", flush=True)

    print(f"[proc {pid}] PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
