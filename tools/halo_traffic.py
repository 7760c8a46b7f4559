"""Measure cross-device halo traffic of the sharded step.

Builds ShardedChain for the benchmark configs on the virtual CPU mesh,
walks the traced jaxpr, and counts every collective's actual operand
bytes — ppermute (halo tails), all_gather (DC prefix composition + AGC
segment energies), psum (I/Q estimator broadcast, digital-AGC pmax).
This is a MEASUREMENT of the compiled program, not a hand model: the
table is what crosses the device interconnect (NVLink between the GPUs
of one host) per step, which with the measured per-step compute time
yields a multi-device scaling projection.

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python tools/halo_traffic.py [--json]
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

# the measurement is trace-based, so the CPU backend is always right for
# it: set BEFORE any backend query
if "pytest" not in sys.modules:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

COLLECTIVES = ("ppermute", "all_gather", "psum", "pmax", "all_to_all",
               "reduce_scatter")


def _walk(jaxpr, hits, seen=None):
    seen = set() if seen is None else seen
    if id(jaxpr) in seen:
        return
    seen.add(id(jaxpr))
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if any(name.startswith(c) for c in COLLECTIVES):
            axes = eqn.params.get("axes") or eqn.params.get("axis_name")
            nbytes = sum(int(np.prod(v.aval.shape)) * v.aval.dtype.itemsize
                         for v in eqn.invars
                         if hasattr(v.aval, "shape"))
            hits.append({"prim": name, "axes": str(axes),
                         "shapes": [tuple(v.aval.shape) for v in eqn.invars
                                    if hasattr(v.aval, "shape")],
                         "bytes_per_shard": nbytes})
        # recurse into call/closed jaxprs (shard_map, pjit, cond, scan) —
        # NOTE cond carries one jaxpr per branch: a collective inside it
        # would be counted once per branch; the sharded step keeps all
        # collectives OUTSIDE the reset cond, so each appears once
        for v in eqn.params.values():
            if hasattr(v, "jaxpr"):           # ClosedJaxpr
                _walk(v.jaxpr, hits, seen)
            elif hasattr(v, "eqns"):          # Jaxpr
                _walk(v, hits, seen)
            elif isinstance(v, (list, tuple)):
                for item in v:
                    if hasattr(item, "jaxpr"):
                        _walk(item.jaxpr, hits, seen)
                    elif hasattr(item, "eqns"):
                        _walk(item, hits, seen)


def measure(cfg, mesh, execute=False):
    from iq_tool_tpu.parallel.sharded import ShardedChain
    sc = ShardedChain(cfg, mesh)
    carry = sc.init_carry()
    raw = np.zeros((cfg.channels, sc.in_wire_len), sc.in_wire_dtype)
    jx = jax.make_jaxpr(lambda c, r, f: sc.step(c, r, f))(
        carry, raw, np.bool_(False))
    hits = []
    _walk(jx.jaxpr, hits)
    if execute:
        # compile+run once so the counts describe a program that runs
        # (full CLI framing is trace-only: CPU compile of the grown notch
        # block takes tens of minutes, while the collective set is
        # framing-independent — verified by the small-framing run)
        sc.step(carry, raw, np.bool_(False))[1].block_until_ready()
    return sc, hits


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    from iq_tool_tpu.ops.fir_design import FilterRequest
    from iq_tool_tpu.parallel.sharded import make_mesh
    from iq_tool_tpu.pipeline.chain import ChainConfig

    mesh = make_mesh(jax.devices(), channel_shards=1, time_shards=8)
    t = mesh.shape["time"]

    configs = {
        "flagship (#1): dc+shift+resample+lp400k": ChainConfig(
            input_format="cs16", output_format="cs16",
            input_rate=2_048_000.0, target_rate=1_488_375.0, channels=8,
            dc_block=True, freq_shift_pre_hz=-100e3,
            filters=[FilterRequest("lowpass", 400e3)], target_block=16384),
        "notch (#4): dc+iq+2 shifts+resample+notch+agc": ChainConfig(
            input_format="cs16", output_format="cs16",
            input_rate=2_048_000.0, target_rate=1_488_375.0, channels=8,
            dc_block=True, iq_correction=True, freq_shift_pre_hz=-100e3,
            freq_shift_post_hz=25e3, agc_profile="local",
            filters=[FilterRequest("stop-range", 0.0, 10_000.0)],
            target_block=16384),
    }

    # prove the sharded program executes (small framing, fast CPU compile)
    small = ChainConfig(**{**configs[next(iter(configs))].__dict__,
                           "target_block": 2048})
    measure(small, mesh, execute=True)

    report = {"time_shards": t, "configs": {}}
    for name, cfg in configs.items():
        sc, hits = measure(cfg, mesh)
        per_shard = sum(h["bytes_per_shard"] for h in hits)
        entry = {
            "channels": cfg.channels,
            "n_in_global": sc.n_in,
            "n_in_per_shard": sc.local.n_in,
            "collectives": hits,
            "bytes_per_shard_per_step": per_shard,
            "bytes_per_input_sample_per_shard":
                per_shard / sc.local.n_in / cfg.channels,
        }
        report["configs"][name] = entry
        if not args.json:
            print(f"\n== {name} ==")
            print(f"   global n_in {sc.n_in} ({t} shards x {sc.local.n_in}), "
                  f"channels {cfg.channels}")
            for h in hits:
                print(f"   {h['prim']:<22} axes={h['axes']:<20} "
                      f"shapes={h['shapes']} -> {h['bytes_per_shard']} B/shard")
            print(f"   TOTAL {per_shard} B/shard/step "
                  f"({per_shard / sc.local.n_in:.2f} B per input frame/shard "
                  f"at {cfg.channels} channels)")
    if args.json:
        print(json.dumps(report, indent=1, default=str))
    return report


if __name__ == "__main__":
    main()
