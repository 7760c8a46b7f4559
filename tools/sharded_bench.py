"""Sharding overhead on one device.

The same flagship chain at the same global framing, plain `Chain` vs
`ShardedChain` on a 1x1 mesh (the T == 1 stitch is a static no-op, so
the sharded program should cost what the plain program costs).
Multi-device efficiency itself needs several devices (chip_smoke.py
--multi) and the halo bytes of tools/halo_traffic.py.

Honest timing: same scan-difference harness as bench.py.

Usage: python tools/sharded_bench.py [--channels 128] [--block 262144]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(step_fn, build_carry, raw, n_in, channels, reps=3):
    import jax
    import jax.numpy as jnp

    raw_dev = jax.device_put(raw)

    def make(n_steps):
        @jax.jit
        def run(raw_in):
            def body(carry, _):
                carry, out = step_fn(carry, raw_in, jnp.bool_(False))
                return carry, jnp.sum(out[:1, :8].astype(jnp.float32))
            _, sums = jax.lax.scan(body, build_carry(), None,
                                   length=n_steps)
            return jnp.sum(sums)
        return run

    k1, k2 = 3, 13
    f1, f2 = make(k1), make(k2)
    float(f1(raw_dev))
    float(f2(raw_dev))
    per = None
    for _ in range(reps):
        t0 = time.perf_counter()
        float(f1(raw_dev))
        t1 = time.perf_counter()
        float(f2(raw_dev))
        t2 = time.perf_counter()
        d = ((t2 - t1) - (t1 - t0)) / (k2 - k1)
        per = d if per is None else min(per, d)
    return channels * n_in / per / 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--block", type=int, default=1 << 18)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from iq_tool_tpu.ops.fir_design import FilterRequest
    from iq_tool_tpu.parallel.sharded import ShardedChain, make_mesh
    from iq_tool_tpu.pipeline.chain import Chain, ChainConfig

    cfg = ChainConfig(
        input_format="cs16", output_format="cs16",
        input_rate=2_048_000.0, target_rate=1_488_375.0,
        channels=args.channels, dc_block=True,
        freq_shift_pre_hz=100_000.0,
        filters=[FilterRequest("lowpass", 400_000.0)],
        target_block=args.block)

    rng = np.random.default_rng(0)

    plain = Chain(cfg)
    raw = rng.integers(-2 ** 15, 2 ** 15,
                       (args.channels, plain.in_wire_len)).astype(np.int16)
    msps_plain = measure(plain._step,
                         lambda: plain._build_carry(args.channels),
                         raw, plain.n_in, args.channels)
    print(json.dumps({"variant": "plain", "channels": args.channels,
                      "Msps_in": round(msps_plain, 1)}), flush=True)

    sc = ShardedChain(cfg, make_mesh(jax.devices()[:1], 1, 1))
    raw_s = rng.integers(-2 ** 15, 2 ** 15,
                         (args.channels, sc.in_wire_len)).astype(np.int16)

    def sharded_carry():
        # init_carry jits with out_shardings; inside this scan harness we
        # rebuild it per trace the same way bench does for the plain chain
        import jax.numpy as jnp
        struct = sc._carry_struct()
        out = {}
        for name, spec in struct.items():
            if spec[0] == "halo":
                out[name] = jnp.zeros((cfg.channels, sc.t * spec[1]),
                                      jnp.float32)
            else:
                out[name] = spec[1](cfg.channels)
        return out

    msps_sharded = measure(sc.step, sharded_carry, raw_s, sc.n_in,
                           args.channels)
    print(json.dumps({"variant": "sharded_1x1", "channels": args.channels,
                      "Msps_in": round(msps_sharded, 1),
                      "overhead_pct": round(
                          100.0 * (1 - msps_sharded / msps_plain), 1)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
