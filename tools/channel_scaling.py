"""Channel-scaling sweep on one GPU.

Aggregate Msps of the flagship chain at C channels vs C * Msps(1): how
well the data-parallel channel axis fills one device.  Channels shard
across devices with zero cross-talk, so per-device batching efficiency
is the dominant factor of multi-device scaling; the only cross-device
costs are the time-axis halos, one (C, H) ppermute per stateful stage
per step.

    python tools/channel_scaling.py [--block N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_all import IN_RATE, OUT_RATE, measure  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--block", type=int, default=1 << 18)
    ap.add_argument("--fold", type=int, default=1,
                    help="time-fold F per channel (pipeline/folded.py)")
    ap.add_argument("--channels", type=int, nargs="*",
                    default=[1, 4, 16, 64, 128])
    opts = ap.parse_args()

    from iq_tool_tpu.ops.fir_design import FilterRequest
    from iq_tool_tpu.pipeline.chain import ChainConfig

    for c in opts.channels:
        cfg = ChainConfig(
            input_format="cs16", output_format="cs16",
            input_rate=IN_RATE, target_rate=OUT_RATE,
            channels=c, dc_block=True, freq_shift_pre_hz=100e3,
            filters=(FilterRequest("lowpass", 400e3),),
            target_block=opts.block)
        # small-channel steps are sub-millisecond; stretch the in-jit scan
        # so the two-length difference dwarfs dispatch jitter
        ks = (10, 110) if c <= 16 else (3, 23)
        msps = measure(cfg, c, ks=ks, fold=opts.fold)
        print(json.dumps({"channels": c, "fold": opts.fold,
                          "Msps_in": round(msps, 1),
                          "per_channel": round(msps / c, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
