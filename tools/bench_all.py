"""Measure all five BASELINE.json configs on the GPU (one JSON line each).

Timing methodology matches bench.py: K chain steps inside one lax.scan,
checksum readback, difference two scan lengths.

    python tools/bench_all.py [--channels N] [--block N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

IN_RATE, OUT_RATE = 2_048_000.0, 1_488_375.0


def measure(chain_cfg, channels: int, reps: int = 3,
            ks: tuple = (3, 13), fold: int = 1) -> float:
    import jax
    import jax.numpy as jnp

    from iq_tool_tpu.pipeline.chain import Chain

    if fold > 1:
        from iq_tool_tpu.pipeline.folded import FoldedChain
        chain = FoldedChain(chain_cfg, fold)
    else:
        chain = Chain(chain_cfg)
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 255, (channels, chain.in_wire_len)) \
        .astype(chain.in_wire_dtype)
    if chain.in_wire_dtype == np.int16:
        raw = rng.integers(-2 ** 15, 2 ** 15,
                           (channels, chain.in_wire_len)).astype(np.int16)
    raw_dev = jax.device_put(raw)

    def make(n_steps: int):
        @jax.jit
        def run(raw_in):
            def body(carry, _):
                carry, out = chain._step(carry, raw_in, jnp.bool_(False))
                return carry, jnp.sum(out[:1, :8].astype(jnp.float32))
            carry0 = chain._build_carry(channels)
            _, sums = jax.lax.scan(body, carry0, None, length=n_steps)
            return jnp.sum(sums)
        return run

    k1, k2 = ks
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
    return channels * chain.n_in / per / 1e6


def make_configs(channels: int, block: int) -> dict:
    """The five BASELINE.json measurement configs (shared with bench.py
    and chip_smoke.py so every measurement uses the same chains)."""
    from iq_tool_tpu.ops.fir_design import FilterRequest
    from iq_tool_tpu.pipeline.chain import ChainConfig

    base = dict(input_rate=IN_RATE, target_rate=OUT_RATE,
                channels=channels, target_block=block)
    return {
        "1: raw cs16 -> resample -> cs16": ChainConfig(
            input_format="cs16", output_format="cs16", **base),
        "2: wav16 -> shift +250k -> resample -> lowpass": ChainConfig(
            input_format="cs16", output_format="cs16",
            freq_shift_pre_hz=250e3,
            filters=(FilterRequest("lowpass", 400e3),), **base),
        "3: cu8 -> dc -> fft band-pass -> resample -> cs16": ChainConfig(
            input_format="cu8", output_format="cs16", dc_block=True,
            filters=(FilterRequest("pass-range", 0.0, 400e3),),
            filter_method="fft", filter_stage="pre", **base),
        "4: full chain (shift+iq+notch+resample+shift+agc)": ChainConfig(
            input_format="cs16", output_format="cs16", dc_block=True,
            iq_correction=True, freq_shift_pre_hz=100e3,
            freq_shift_post_hz=-50e3,
            filters=(FilterRequest("stop-range", 0.0, 10e3),),
            agc_profile="local", **base),
        "5: 64-channel full chain (DP batch)": ChainConfig(
            input_format="cs16", output_format="cs16", dc_block=True,
            freq_shift_pre_hz=100e3,
            filters=(FilterRequest("lowpass", 400e3),),
            agc_profile="local",
            **{**base, "channels": max(64, channels)}),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--block", type=int, default=1 << 18)
    opts = ap.parse_args()

    import jax
    if jax.default_backend() != "gpu":
        sys.exit("bench_all.py: JAX found no GPU")
    configs = make_configs(opts.channels, opts.block)
    for name, cfg in configs.items():
        msps = measure(cfg, cfg.channels)
        print(json.dumps({"config": name, "channels": cfg.channels,
                          "device": jax.devices()[0].device_kind,
                          "Msps_in": round(msps, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
