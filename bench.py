"""Benchmark: complex Msamples/s on one GPU for the resample+filter chain.

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device"}.  Exits non-zero
when JAX finds no GPU.

Config is BASELINE.json #1/#2: cs16 -> DC -> shift -> resample
2.048 -> 1.488375 Msps -> lowpass FIR -> cs16, batched over enough
channels to fill the device.  The metric counts INPUT complex samples
per second.

Baseline: the C reference cannot be built in this image (liquid-dsp and
libsndfile are absent, no network), so the baseline is an equivalent C
implementation of the same chain — native/baseline/iq_baseline.c, built
with the reference's DSP regime (-O3 -march=native -ffast-math, pthreads)
and verified to the 60 dB contract (61.4 dB tone SNR).  Measured once and
cached in BASELINE_MEASURED.json with provenance; threads = nproc (this
host has 1 core, so the multi-threaded build equals single-thread here).
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
CACHE = os.path.join(HERE, "BASELINE_MEASURED.json")

IN_RATE = 2_048_000.0
OUT_RATE = 1_488_375.0
LOWPASS_HZ = 400_000.0


def measure_device(channels: int = int(os.environ.get("IQ_BENCH_CHANNELS", 128)),
                   block: int = int(os.environ.get("IQ_BENCH_BLOCK", 1 << 18)),
                   reps: int = int(os.environ.get("IQ_BENCH_REPS", 3)),
                   cfg=None) -> float:
    """Steady-state device throughput (cfg=None -> the flagship chain).

    The K step iterations run INSIDE one compiled program (``lax.scan``)
    and the per-step time is the difference between a long and a short
    scan, so constant compile/dispatch/readback overheads cancel; every
    timed run ends with a host readback of a checksum.
    """
    import jax
    import jax.numpy as jnp

    from iq_tool_tpu.ops.fir_design import FilterRequest
    from iq_tool_tpu.pipeline.chain import Chain, ChainConfig

    if cfg is None:
        cfg = ChainConfig(
            input_format="cs16", output_format="cs16",
            input_rate=IN_RATE, target_rate=OUT_RATE,
            channels=channels,
            dc_block=True,
            freq_shift_pre_hz=100_000.0,
            filters=[FilterRequest("lowpass", LOWPASS_HZ)],
            target_block=block,
        )
    chain = Chain(cfg)
    rng = np.random.default_rng(0)
    raw = rng.integers(-2 ** 15, 2 ** 15,
                       (channels, chain.in_wire_len)).astype(np.int16)
    raw = raw.astype(chain.in_wire_dtype)
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

    k1, k2 = 3, 13
    f1, f2 = make(k1), make(k2)
    float(f1(raw_dev))    # compile + warm
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
    samples = channels * chain.n_in
    return samples / per / 1e6


def measure_c_baseline() -> float:
    """Build + run the equivalent-chain C baseline (multi-threaded)."""
    import subprocess
    src_dir = os.path.join(HERE, "native", "baseline")
    binary = os.path.join(src_dir, "iq_baseline")
    if not os.path.isfile(binary):
        subprocess.run(
            ["gcc", "-O3", "-march=native", "-ffast-math",
             "-o", binary, os.path.join(src_dir, "iq_baseline.c"),
             "-lm", "-lpthread"], check=True, timeout=120)
    nproc = os.cpu_count() or 1
    out = subprocess.run(
        [binary, str(1 << 21), str(nproc), "5"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(json.loads(out.stdout.strip().splitlines()[-1])["value"])


def main():
    if os.path.isfile(CACHE):
        with open(CACHE) as f:
            baseline = json.load(f)["cpu_msps"]
    else:
        baseline = measure_c_baseline()
        note = ("equivalent-chain C baseline (native/baseline/iq_baseline.c,"
                " -O3 -march=native -ffast-math, threads=nproc); 61.4 dB"
                " tone SNR; the reference binary itself is unbuildable here"
                " (no liquid-dsp, no network)")
        with open(CACHE, "w") as f:
            json.dump({"cpu_msps": baseline, "note": note,
                       "chain": "cs16 dc+shift+resample(11907/16384)+lowpass"},
                      f, indent=1)

    import jax

    from iq_tool_tpu.utils import compile_cache
    compile_cache.enable()
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py: JAX found no GPU (backend "
                 f"{jax.default_backend()!r})")
    import subprocess
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card}

    value = measure_device()
    # all five BASELINE.json configs beside the flagship; a config that
    # fails stops the run
    extra = {}
    if not os.environ.get("IQ_BENCH_FLAGSHIP_ONLY"):
        from tools.bench_all import make_configs
        channels = int(os.environ.get("IQ_BENCH_CHANNELS", 128))
        block = int(os.environ.get("IQ_BENCH_BLOCK", 1 << 18))
        cfgs = {"flagship": round(value, 2)}
        for name, cfg in make_configs(channels, block).items():
            cfgs[name] = round(measure_device(cfg=cfg), 2)
        extra["configs"] = cfgs
    print(json.dumps({
        "metric": "complex Msamples/s (resample+filter chain, input rate)",
        "value": round(value, 2),
        "unit": "Msamples/s",
        "vs_baseline": round(value / baseline, 2),
        "device": device,
        **extra,
    }))


if __name__ == "__main__":
    main()
