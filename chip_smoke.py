"""Run the I/Q chain's main path once on the GPU and check what comes out.

    python chip_smoke.py           # one card: phases 1-4
    python chip_smoke.py --multi   # four cards: phase 5 and its comparison

1. Device and card: JAX must report a GPU; the card's name and power
   limit come from nvidia-smi in a child process that never imports JAX.
2. CLI end to end, single stream: a 2^24-frame cs16 tone file at
   2.048 Msps through ``cli.main`` (flagship options: DC block, +100 kHz
   shift, resample to 1.488375 Msps, 400 kHz lowpass), file to file.
   Checks the exact frame count, the tone frequency and >= 60 dB tone SNR.
3. Batched Chain at bench width: the flagship and the five BASELINE.json
   configs at 128 channels x 2^18 frames, three steps on one carry.
   Checks the tone SNR of each and parity with the same steps run on the
   CPU backend of this process; prints each step's memory analysis.
4. Engine times: the banded Pallas kernel and the plain XLA windows +
   matmul at each banded map of the flagship and config #2, and the FFT
   overlap-save filter of config #4, on the host clock around
   block_until_ready.
5. (--multi) ShardedChain through the CLI on a 2x2 and a 1x4 mesh,
   compared with the single-card Chain, and the device placement of a
   sharded step's output.

A failed check raises; the last line of standard output is the JSON
result, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
IN_RATE, OUT_RATE = 2_048_000.0, 1_488_375.0
TONE_HZ, SHIFT_HZ, LOWPASS_HZ = 100e3, 100e3, 400e3
FLAGSHIP_ARGS = ["--dc-block", "--freq-shift", str(SHIFT_HZ),
                 "--lowpass", str(LOWPASS_HZ)]


def log(*parts) -> None:
    print(*parts, flush=True)


def card() -> str:
    """The card's name and power limit, read without touching JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def tone_wire(n: int, fmt: str, channels: int = 1, start: int = 0,
              seed: int = 0) -> np.ndarray:
    """(channels, n * 2) wire of complex tones at TONE_HZ: a random phase
    and an amplitude in [0.3, 0.5] per channel, sample indices from
    ``start`` so consecutive calls continue the tone."""
    from tests import ref_dsp
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.3, 0.5, (channels, 1))
    ph = rng.uniform(0, 2 * np.pi, (channels, 1))
    t = (start + np.arange(n)) / IN_RATE
    z = amp * np.exp(1j * (2 * np.pi * TONE_HZ * t + ph))
    return ref_dsp.from_cf32(z.astype(np.complex64).ravel(), fmt).reshape(
        channels, -1)


def flagship_config(channels: int, block: int):
    from iq_tool_tpu.ops.fir_design import FilterRequest
    from iq_tool_tpu.pipeline.chain import ChainConfig
    return ChainConfig(input_format="cs16", output_format="cs16",
                       input_rate=IN_RATE, target_rate=OUT_RATE,
                       channels=channels, dc_block=True,
                       freq_shift_pre_hz=SHIFT_HZ,
                       filters=(FilterRequest("lowpass", LOWPASS_HZ),),
                       target_block=block)


def bench_configs(channels: int, block: int) -> dict:
    """The flagship and the five BASELINE.json configs."""
    sys.path.insert(0, HERE)
    from tools.bench_all import make_configs
    return {"flagship": flagship_config(channels, block),
            **make_configs(channels, block)}


# ------------------------------------------------------------------ phase 1

def phase_device() -> dict:
    import jax
    devs = jax.devices()
    log("devices:", devs, "kind:", devs[0].device_kind)
    log("card:", card())
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# ------------------------------------------------------------------ phase 2

def phase_cli(tmp: str, frames: int = 1 << 24) -> dict:
    """Flagship options through cli.main, file to file."""
    from iq_tool_tpu import cli
    from iq_tool_tpu.pipeline.chain import Chain
    from tests import ref_dsp

    src, dst = os.path.join(tmp, "tone.raw"), os.path.join(tmp, "out.raw")
    tone_wire(frames, "cs16")[0].tofile(src)
    argv = [src, dst, "-i", "raw-file", "-o", "raw",
            "--raw-file-input-rate", str(int(IN_RATE)),
            "--raw-file-input-sample-format", "cs16",
            "--output-rate", str(OUT_RATE), "--output-sample-format", "cs16",
            *FLAGSHIP_ARGS, "--force-overwrite"]
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    out = np.fromfile(dst, np.int16)
    want = Chain(flagship_config(1, 16384)).expected_out_frames(frames)
    if out.size != 2 * want:
        raise AssertionError(f"{out.size // 2} frames out, expected {want}")
    z = ref_dsp.to_cf32(out, "cs16")[20000:]
    peak, snr = ref_dsp.tone_snr(z, OUT_RATE)
    log(f"phase 2 cli: {frames} frames in, {want} out (exact), "
        f"tone {peak:.3f} Hz, SNR {snr:.2f} dB, wall {wall:.2f} s")
    if abs(peak - (TONE_HZ + SHIFT_HZ)) > 2 * OUT_RATE / len(z):  # 2 bins
        raise AssertionError(f"tone at {peak} Hz, expected "
                             f"{TONE_HZ + SHIFT_HZ}")
    if snr < 60.0:
        raise AssertionError(f"CLI tone SNR {snr:.2f} dB < 60")
    return {"frames_out": want, "tone_hz": peak, "snr_db": snr}


# ------------------------------------------------------------------ phase 3

def run_steps(cfg, wires, device):
    """Chain(cfg) stepped over ``wires`` on ``device`` with one carry:
    (host outputs, compiled step)."""
    import jax
    from iq_tool_tpu.pipeline.chain import Chain
    chain = Chain(cfg)
    with jax.default_device(device):
        carry = chain.init_carry()
    raws = [jax.device_put(w, device) for w in wires]
    compiled = chain.step.lower(carry, raws[0], np.False_).compile()
    outs = []
    for raw in raws:
        carry, out = compiled(carry, raw, np.False_)
        outs.append(np.asarray(out))
    return np.concatenate(outs, axis=-1), compiled


def phase_batched(channels: int = 128, block: int = 1 << 18,
                  steps: int = 3, ref_device=None, names=None,
                  device=None) -> dict:
    """Each config (or those in ``names``) on ``device`` (default: the
    first device) vs the CPU backend."""
    import jax
    from iq_tool_tpu.pipeline.chain import Chain
    from tests import ref_dsp

    ref_device = ref_device or jax.devices("cpu")[0]
    device = device or jax.devices()[0]
    results = {}
    wires: dict = {}
    for name, cfg in bench_configs(channels, block).items():
        if names is not None and name not in names:
            continue
        chain = Chain(cfg)
        fmt, n = cfg.input_format, chain.n_in
        key = (fmt, cfg.channels, n)
        if key not in wires:
            wires[key] = [tone_wire(n, fmt, cfg.channels, start=k * n)
                          for k in range(steps)]
        w = wires[key]
        t0 = time.perf_counter()
        got, compiled = run_steps(cfg, w, device)
        t_dev = time.perf_counter() - t0
        log(f"phase 3 {name}: memory {compiled.memory_analysis()}")
        want, _ = run_steps(cfg, w, ref_device)
        # The first step holds the zero-history start-up transient, where
        # the AGC gain is set by the filters' round-off floor (cuFFT and
        # the CPU FFT differ there): the whole record is held to the
        # parity SNR, the steps after it to the full contract.
        l = chain.out_wire_len
        par = ref_dsp.assert_parity(got[:, l:], want[:, l:], name)
        par_all = ref_dsp.parity_snr(got, want)
        if par_all <= 60.0:
            raise AssertionError(f"{name}: parity {par_all:.2f} dB <= 60")
        # tone SNR after the first step's start-up transient; an 8-bit
        # wire caps it at the input's own SNR
        snrs, in_snrs = [], []
        for c in sorted({0, cfg.channels // 2, cfg.channels - 1}):
            z = ref_dsp.to_cf32(got[c, l:], cfg.output_format)
            snrs.append(ref_dsp.tone_snr(z, cfg.output_rate)[1])
            zi = ref_dsp.to_cf32(np.concatenate([x[c] for x in w]), fmt)
            in_snrs.append(ref_dsp.tone_snr(zi, IN_RATE)[1])
        snr, floor = min(snrs), min(60.0, min(in_snrs))
        log(f"phase 3 {name}: {cfg.channels}x{n} frames x {steps} steps, "
            f"tone SNR {snr:.2f} dB (floor {floor:.2f}), parity vs "
            f"{ref_device.platform} {par_all:.2f} dB (steps 2-{steps}: "
            f"{par:.2f} dB, codes within the cap), device run {t_dev:.2f} s "
            f"incl. compile")
        if snr < floor:
            raise AssertionError(f"{name}: tone SNR {snr:.2f} < {floor:.2f}")
        results[name] = {"snr_db": snr, "parity_db": par_all}
    return results


# ------------------------------------------------------------------ phase 4

def _median_ms(fn, reps: int = 20) -> float:
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(ts)


def banded_maps(chain):
    """(name, A_r, A_i, stride, hist, n) of every banded map in a chain:
    its resampler stages and a direct FIR before them."""
    from iq_tool_tpu import constants as C
    from iq_tool_tpu.ops import banded
    maps, n = [], chain.n_in
    f = chain.pre_filter
    if f is not None and f._exec_banded and f.num_taps > 1:
        s = banded.largest_divisor_leq(n, C.BANDED_STRIDE_CAP)
        tr, ti = f._toeplitz_for(s)
        maps.append(("pre FIR", tr, ti, s, f.num_taps - 1, n))
    for k, st in enumerate(chain.resampler.stages):
        maps.append((f"stage {k}", st._a, st._a_i, st.stride, st.hist, n))
        n = n * st.p // st.q
    return maps


def banded_engine_ms(a_r, a_i, stride: int, hist: int, n: int,
                     channels: int, kernel: bool = True) -> dict:
    """Median ms of one banded map on random planes: the XLA windows +
    matmul, and (``kernel``) the Pallas kernel."""
    import jax
    import jax.numpy as jnp
    from iq_tool_tpu.ops import banded, banded_kernel

    rng = np.random.default_rng(1)
    plane = lambda w: jnp.asarray(rng.standard_normal((channels, w)),
                                  jnp.float32)
    args = (plane(hist), plane(hist), plane(n), plane(n))
    engines = {"xla": banded._apply_xla}
    if kernel:
        engines["kernel"] = banded_kernel.apply
    times = {}
    for label, fn in engines.items():
        f = jax.jit(lambda *v, fn=fn: fn(*v, a_r, a_i, stride, hist))
        times[label] = _median_ms(lambda: f(*args))
    return times


def phase_engines(channels: int = 128, block: int = 1 << 18,
                  kernel: bool = True) -> dict:
    """Median times of the banded kernel and the plain XLA windows +
    matmul at every banded map of the flagship and config #2 (which
    engine the chain picks is printed beside them), and of config #4's
    overlap-save filter.  ``kernel=False`` skips the kernel (it has no
    lowering off the GPU)."""
    import jax
    import jax.numpy as jnp
    from iq_tool_tpu.ops import banded
    from iq_tool_tpu.ops.precision import DOT
    from iq_tool_tpu.pipeline.chain import Chain

    cfgs = bench_configs(channels, block)
    rng = np.random.default_rng(1)
    plane = lambda *s: jnp.asarray(rng.standard_normal(s), jnp.float32)
    res = {}
    for name in ("flagship", "2: wav16 -> shift +250k -> resample -> lowpass"):
        for tag, a_r, a_i, s, h, n in banded_maps(Chain(cfgs[name])):
            times = banded_engine_ms(a_r, a_i, s, h, n, channels, kernel)
            key = f"{name.split(':')[0]} {tag}"
            res[key] = times
            pick = "kernel" if banded.use_kernel(s, h, n // s) else "xla"
            log(f"phase 4 banded {key}: stride {s} hist {h} G "
                f"{a_r.shape[1]} n {n} x {channels}: " + ", ".join(
                    f"{k} {v:.3f} ms" for k, v in times.items())
                + f" (precision {DOT.name}; the GPU path uses {pick})")
    chain = Chain(cfgs["4: full chain (shift+iq+notch+resample+shift+agc)"])
    filt = chain.post_filter
    x, y = plane(channels, chain.n_out), plane(channels, chain.n_out)
    st = jnp.zeros((channels, filt.block), jnp.float32)
    f = jax.jit(lambda a, b: filt.apply_planar(a, b, st, st)[:2])
    ms = _median_ms(lambda: f(x, y))
    res["4 overlap-save"] = {"jnp.fft": ms}
    log(f"phase 4 overlap-save: {filt.num_taps} taps, block {filt.block}, "
        f"n {chain.n_out} x {channels}: jnp.fft {ms:.3f} ms (complex64)")
    return res


# ------------------------------------------------------------------ phase 5

def phase_multi(tmp: str, frames: int = 1 << 20) -> dict:
    """ShardedChain through cli.main on the 2x2 and 1x4 meshes vs the
    single-card Chain (cli.main with no mesh), plus the placement of one
    sharded step's output and carry."""
    import jax
    from iq_tool_tpu import cli
    from iq_tool_tpu.config import resolve_rates, validate
    from tests import ref_dsp

    n_dev = len(jax.devices())
    if n_dev < 4:
        raise RuntimeError(f"--multi needs 4 devices, found {n_dev}")
    common = ["-i", "raw-file", "-o", "raw",
              "--raw-file-input-rate", str(int(IN_RATE)),
              "--raw-file-input-sample-format", "cs16",
              "--output-rate", str(OUT_RATE), "--output-sample-format", "cs16",
              *FLAGSHIP_ARGS, "--force-overwrite"]
    rng = np.random.default_rng(3)
    res = {}
    for channels, mesh in ((4, ["--mesh-channel", "2", "--mesh-time", "2"]),
                           (1, ["--mesh-time", "4"])):
        tag = f"{channels}ch " + " ".join(mesh)
        for c in range(channels):
            rng.integers(-2 ** 13, 2 ** 13, 2 * frames).astype(
                np.int16).tofile(os.path.join(tmp, f"in_{c}.raw"))
        chan = ["--channels", str(channels)]
        src = os.path.join(tmp, "in_{ch}.raw" if channels > 1 else "in_0.raw")
        out_s = os.path.join(tmp, "sh_{ch}.raw" if channels > 1 else "sh_0.raw")
        out_1 = os.path.join(tmp, "one_{ch}.raw" if channels > 1
                             else "one_0.raw")
        if cli.main([src, out_s, *common, *chan, *mesh]) != 0:
            raise RuntimeError(f"sharded CLI run failed ({tag})")
        if cli.main([src, out_1, *common, *chan]) != 0:
            raise RuntimeError(f"single-card CLI run failed ({tag})")
        snrs, exact = [], True
        for c in range(channels):
            a = np.fromfile(os.path.join(tmp, f"sh_{c}.raw"), np.int16)
            b = np.fromfile(os.path.join(tmp, f"one_{c}.raw"), np.int16)
            exact &= bool(np.array_equal(a, b))
            snrs.append(ref_dsp.assert_parity(a, b, tag))
        # placement: one step of the same ShardedChain the CLI builds
        args = cli.build_parser().parse_args(
            [src, out_s, *common, *chan, *mesh])
        cfg = cli.config_from_args(args)
        resolve_rates(cfg, IN_RATE, "cs16")
        validate(cfg)
        chain = cli.build_chain(cfg, args.block_size, channels=channels,
                                mesh_channel=args.mesh_channel,
                                mesh_time=args.mesh_time)
        raw = np.zeros((channels, chain.in_wire_len), np.int16)
        carry, out = chain.step(chain.init_carry(), raw, np.False_)
        devs = {sh.device for sh in out.addressable_shards}
        carry_devs = {sh.device for leaf in jax.tree_util.tree_leaves(carry)
                      for sh in leaf.addressable_shards}
        log(f"phase 5 {tag}: {type(chain).__name__}, parity vs single card "
            f"min {min(snrs):.2f} dB, bit-exact {exact}, output on "
            f"{sorted(d.id for d in devs)}, carry on "
            f"{sorted(d.id for d in carry_devs)}")
        if len(devs) != 4 or len(carry_devs) != 4:
            raise AssertionError(f"{tag}: output/carry not on 4 devices")
        res[tag] = {"parity_db": min(snrs), "bit_exact": exact}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card ShardedChain phase")
    opts = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    import jax
    from iq_tool_tpu.utils import compile_cache
    compile_cache.enable()
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 1
    device = phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        if opts.multi:
            phase_multi(tmp)
        else:
            phase_cli(tmp)
            phase_batched()
            phase_engines()
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
