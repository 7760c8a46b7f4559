"""Banded kernel vs plain XLA on the GPU: per map and end to end.

    python tools/banded_ab.py [--channels 128] [--blocks 262144 16384]

For the flagship and the five BASELINE.json configs at each block size:
every banded map timed with both engines (the rule in ops/banded.py
picks between them from the window length and count), then Chain.step
with the rule in force
against Chain.step with every map on XLA, in turns (xla, rule, rule,
xla).  One JSON line per measurement; times are medians on the host
clock around block_until_ready.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def step_ms(cfg, steps: int = 10) -> float:
    import jax
    from iq_tool_tpu.pipeline.chain import Chain
    chain = Chain(cfg)
    raw = np.random.default_rng(0).integers(
        -2 ** 14, 2 ** 14, (cfg.channels, chain.in_wire_len))
    raw = jax.device_put(raw.astype(chain.in_wire_dtype))
    carry = chain.init_carry()
    for _ in range(2):
        carry, out = chain.step(carry, raw, np.False_)
    jax.block_until_ready((carry, out))
    t0 = time.perf_counter()
    for _ in range(steps):
        carry, out = chain.step(carry, raw, np.False_)
    jax.block_until_ready((carry, out))
    return 1e3 * (time.perf_counter() - t0) / steps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--blocks", type=int, nargs="*", default=[1 << 18, 16384])
    opts = ap.parse_args()

    import jax
    import chip_smoke
    from iq_tool_tpu.ops import banded
    from iq_tool_tpu.pipeline.chain import Chain
    from iq_tool_tpu.utils import compile_cache
    compile_cache.enable()
    if jax.default_backend() != "gpu":
        sys.exit("banded_ab.py: JAX found no GPU")
    print(chip_smoke.card(), flush=True)
    rule = banded.use_kernel
    c = opts.channels
    for block in opts.blocks:
        cfgs = chip_smoke.bench_configs(c, block)
        seen = set()
        for name, cfg in cfgs.items():
            for tag, a_r, a_i, s, h, n in chip_smoke.banded_maps(Chain(cfg)):
                key = (s, h, a_r.shape[1], n, cfg.channels)
                if key in seen:
                    continue
                seen.add(key)
                times = chip_smoke.banded_engine_ms(a_r, a_i, s, h, n,
                                                    cfg.channels)
                print(json.dumps({"block": block, "map": f"{name} {tag}",
                                  "stride": s, "hist": h,
                                  "window": s + h, "G": a_r.shape[1],
                                  "rule": rule(s, h, n // s), **times}),
                      flush=True)
        for name, cfg in cfgs.items():
            row = {}
            for label, fn in (("xla", lambda *a: False), ("rule", rule),
                              ("rule2", rule), ("xla2", lambda *a: False)):
                banded.use_kernel = fn
                row[label] = step_ms(cfg)
            banded.use_kernel = rule
            print(json.dumps({"block": block, "chain": name, **row}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
