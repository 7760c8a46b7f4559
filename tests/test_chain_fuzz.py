"""Randomized differential test: full Chain vs an independent scipy
composition over random configs.

Guards the chain's stage ORCHESTRATION — ordering, carry threading,
block framing — against an oracle built only from scipy primitives and
the chain's published design artifacts (filter taps, resample ratio).

The input is band-limited noise (both resampler designs must pass it
transparently) and the comparison is on PSDs over the occupied band —
alignment-free, so the chain's causal group delay vs scipy's centered
filters does not need fractional-delay estimation.  Catches ordering,
state-threading and scaling bugs; exact numerics are covered by the
per-op oracles.
"""

import numpy as np
import pytest
import scipy.signal as sig

from tests import ref_dsp
from iq_tool_tpu.ops.fir_design import FilterRequest
from iq_tool_tpu.pipeline.chain import Chain, ChainConfig

IN_RATE = 2_048_000.0


def _oracle(wire, cfg: ChainConfig, chain: Chain) -> np.ndarray:
    """scipy composition of the same chain (no AGC/IQ: those are
    covered by their own oracles; here we fuzz the LTI spine)."""
    x = ref_dsp.to_cf32(wire, cfg.input_format, cfg.gain).astype(np.complex128)
    if cfg.dc_block:
        a = 2 * np.pi * 10.0 / cfg.input_rate
        x = sig.lfilter([1.0, -1.0], [1.0, -(1.0 - a)], x)
    if cfg.freq_shift_pre_hz:
        # quantized NCO step, matching the uint32 fixed-point frequency
        step = round((cfg.freq_shift_pre_hz / cfg.input_rate) % 1.0 * 2**32)
        ph = (np.arange(len(x), dtype=np.uint64) * np.uint64(step)) % (1 << 32)
        x = x * np.exp(2j * np.pi * ph.astype(np.float64) / 2**32)
    if chain.pre_filter is not None:
        x = sig.lfilter(chain.designed_filter.taps.astype(np.complex128),
                        [1.0], x)
    if chain.resampler is not None:
        p, q = chain.resampler.plan.p, chain.resampler.plan.q
        x = sig.resample_poly(x, p, q, padtype="constant")
    if chain.post_filter is not None:
        x = sig.lfilter(chain.designed_filter.taps.astype(np.complex128),
                        [1.0], x)
    if cfg.freq_shift_post_hz:
        step = round((cfg.freq_shift_post_hz / cfg.output_rate) % 1.0 * 2**32)
        ph = (np.arange(len(x), dtype=np.uint64) * np.uint64(step)) % (1 << 32)
        x = x * np.exp(2j * np.pi * ph.astype(np.float64) / 2**32)
    return x


# (chain kwargs, noise-band center in Hz AFTER any pre-shift — chosen
# inside each case's surviving passband)
CASES = [
    (dict(input_format="cs16", target_rate=1_488_375.0, dc_block=True,
          freq_shift_pre_hz=100e3,
          filters=(FilterRequest("lowpass", 400e3),)), 150e3),
    (dict(input_format="cu8", target_rate=1_024_000.0,
          filters=(FilterRequest("highpass", 20e3),),
          filter_stage="pre"), 200e3),
    (dict(input_format="cs16", target_rate=None, dc_block=True,
          freq_shift_pre_hz=-250e3,
          filters=(FilterRequest("pass-range", 70e3, 100e3),)), 330e3),
    (dict(input_format="sc16q11", target_rate=1_536_000.0,
          freq_shift_post_hz=50e3,
          filters=(FilterRequest("stop-range", 0.0, 20e3),),
          filter_stage="pre"), 250e3),
    (dict(input_format="cs16", target_rate=512_000.0,
          filters=(FilterRequest("lowpass", 200e3),)), 60e3),
    # upsampling (post-stage impossible: filters forced pre)
    (dict(input_format="cs16", target_rate=4_096_000.0,
          filters=(FilterRequest("lowpass", 500e3),),
          filter_stage="pre"), 120e3),
    # deep decimation (multi-stage cascade)
    (dict(input_format="cs16", target_rate=128_000.0,
          filters=(FilterRequest("lowpass", 50e3),)), 20e3),
    # narrow post-stage notch: 2175 taps > 2048 -> the FFT overlap-save
    # engine
    (dict(input_format="cs16", target_rate=1_488_375.0, dc_block=True,
          filters=(FilterRequest("stop-range", 0.0, 10e3),)), 250e3),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_chain_vs_scipy_oracle(case, rng):
    kw, center = dict(CASES[case][0]), CASES[case][1]
    cfg = ChainConfig(output_format="cf32", input_rate=IN_RATE,
                      channels=1, target_block=8192, **kw)
    chain = Chain(cfg)
    n_blocks = 4
    n = chain.n_in * n_blocks
    # band-limited noise at ~0.3x the narrower Nyquist: transparent to
    # both resampler designs and inside every filter's passband edge
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    lim = 0.08 * min(cfg.input_rate, cfg.output_rate) / cfg.input_rate
    bl = sig.firwin(257, lim)
    z = sig.lfilter(bl, [1.0], z)
    z = z * np.exp(2j * np.pi * center / cfg.input_rate * np.arange(n))
    z = (0.4 * z / np.abs(z).max()).astype(np.complex64)
    wire = np.asarray(ref_dsp.from_cf32(z, cfg.input_format))

    carry = chain.init_carry()
    outs = []
    for b in range(n_blocks):
        blk = wire[b * chain.in_wire_len:(b + 1) * chain.in_wire_len]
        carry, out = chain.step(carry, blk[None, :], np.False_)
        outs.append(np.asarray(out)[0])
    got_f = np.concatenate(outs)
    got = (got_f[0::2] + 1j * got_f[1::2]).astype(np.complex128)

    ref = _oracle(wire, cfg, chain)
    m = min(len(ref), len(got))
    skip = min(4096, m // 4)          # startup transients / group delays
    a, b_ = got[skip:m - skip], ref[skip:m - skip]
    nseg = min(1024, len(a) // 8)
    fa, pa = sig.welch(a, nperseg=nseg, return_onesided=False)
    fb, pb = sig.welch(b_, nperseg=nseg, return_onesided=False)
    # compare over bins carrying real signal power (top 40 dB of the ref)
    mask = pb > pb.max() * 1e-4
    assert mask.sum() > nseg // 32
    err = np.abs(10 * np.log10(pa[mask] / pb[mask]))
    # deep multi-stage cascades accumulate ~0.15 dB of passband ripple
    # per stage (per-phase DC normalization); budget accordingly
    n_stages = len(chain.resampler.plan.stages) if chain.resampler else 0
    med_budget = 0.5 if n_stages <= 2 else 0.25 * n_stages
    assert np.median(err) < med_budget and err.max() < 3.0, (
        f"case {case}: PSD deviation median {np.median(err):.2f} dB "
        f"max {err.max():.2f} dB (budget {med_budget})")


# ---------------- fold / shard stitch fuzz ------------------------------------
# The fold and shard stitch math (cross-row/shard halos, zero-start DC
# prefix composition) is where config-dependent bugs hide; these differential tests draw RANDOM configs and assert parity
# against the plain Chain on the same random config (not scipy: the
# per-op numerics are covered by the oracles above; here the oracle is
# the unstitched orchestration itself).

def _draw_cfg(rs: np.random.Generator, channels: int):
    """A random ChainConfig drawn from the supported component pools."""
    fmt_in = rs.choice(["cs16", "cu8", "sc16q11"])
    target = rs.choice([1_488_375.0, 1_024_000.0, 512_000.0, 0.0])
    filt = rs.choice(["none", "lowpass", "stop", "pass"])
    # filter edges must sit inside BOTH Nyquists (the config validator
    # rejects a chain whose filters the output rate cannot carry)
    nyq = min(IN_RATE, target or IN_RATE) / 2.0
    filters = {
        "none": (),
        "lowpass": (FilterRequest("lowpass", 0.54 * nyq),),
        # 0:10e3 at the output rate designs >2048 taps -> the FFT
        # overlap-save engine, the hairiest sharded geometry
        "stop": (FilterRequest("stop-range", 0.0, 10e3),),
        "pass": (FilterRequest("pass-range", 0.07 * nyq, 0.4 * nyq),),
    }[filt]
    agc = rs.choice(["none", "local", "digital"])
    return ChainConfig(
        input_format=str(fmt_in), output_format="cs16",
        input_rate=IN_RATE,
        target_rate=float(target) if target else None,
        channels=channels,
        dc_block=bool(rs.integers(0, 2)),
        freq_shift_pre_hz=float(rs.choice([0.0, 150e3, -250e3])),
        freq_shift_post_hz=float(rs.choice([0.0, -25e3])),
        filters=filters,
        agc_profile=None if agc == "none" else str(agc),
        target_block=4096,
    )


def _fuzz_raw(cfg, n_wire, channels, rs):
    """Random wire bytes at <= 1/4 of the format's FULL SCALE (sc16q11
    saturates at 2048, not 32768): an overdriven stream would clip at
    the cs16 output quantizer and turn gain-loop ulp deltas into
    arbitrarily large code deltas, testing the clamp instead of the
    stitch."""
    import iq_tool_tpu.ops.convert as _cv
    dt = _cv.wire_dtype(cfg.input_format)
    if np.dtype(dt) == np.uint8:
        return rs.integers(64, 192, (channels, n_wire)).astype(np.uint8)
    full = round(1.0 / _cv.get_format(cfg.input_format).normalizer)
    return rs.integers(-full // 4, full // 4,
                       (channels, n_wire)).astype(dt)


def _oracle_chain(cfg, sub_block, global_n_in, raws, rows):
    """Plain-Chain oracle at the matching framing.  The digital AGC
    profile locks ONE gain per step off the step's peak, so the folded/
    sharded contract is one update per GLOBAL block (the documented
    semantics, tests/test_folded.py::test_folded_digital_agc_semantics);
    every other component streams, so the oracle runs at the per-row
    sub-block framing where the carry seams are hardest."""
    if cfg.agc_profile == "digital":
        big = Chain(ChainConfig(**{**cfg.__dict__,
                                   "target_block": global_n_in}))
        assert big.n_in == global_n_in
        carry = big.init_carry()
        outs = []
        for raw in raws:
            carry, out = big.step(carry, raw, np.False_)
            outs.append(np.asarray(out))
        return np.concatenate(outs, axis=-1)
    single = Chain(ChainConfig(**{**cfg.__dict__,
                                  "target_block": sub_block}))
    carry = single.init_carry()
    outs = []
    w = single.in_wire_len
    for raw in raws:
        for j in range(rows):
            carry, out = single.step(carry, raw[:, j * w:(j + 1) * w],
                                     np.False_)
            outs.append(np.asarray(out))
    return np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("seed", range(25))
def test_fuzz_folded_vs_chain(seed):
    """FoldedChain (random F) vs the plain Chain fed the same stream in
    F row slices: the fold stitch (cross-row halos, DC prefix
    composition, row NCO phases, cross-row AGC scan) on random configs."""
    from iq_tool_tpu.pipeline.folded import FoldedChain

    rs = np.random.default_rng(1000 + seed)
    cfg = _draw_cfg(rs, channels=1)
    fold = int(rs.choice([2, 4, 8]))
    fc = FoldedChain(cfg, fold=fold)
    raws = [_fuzz_raw(cfg, fc.in_wire_len, 1, rs) for _ in range(2)]

    carry = fc.init_carry()
    outs = []
    for raw in raws:
        carry, out = fc.step(carry, raw, np.False_)
        outs.append(np.asarray(out))
    got = np.concatenate(outs, axis=-1)

    want = _oracle_chain(cfg, fc.local.cfg.target_block, fc.n_in,
                         raws, fold)
    ref_dsp.assert_parity(got, want, (seed, cfg, fold))


@pytest.mark.parametrize("seed", range(25))
def test_fuzz_sharded_vs_chain(seed):
    """ShardedChain (random channel x time mesh on the 8-device CPU
    mesh) vs the plain Chain at the per-shard framing — same random
    config: the halo, DC prefix and AGC shard stitch."""
    import jax

    from iq_tool_tpu.parallel import ShardedChain, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rs = np.random.default_rng(2000 + seed)
    # (4, 1) / (8, 1) exercise the static T==1 stitch bypass
    c_sh, t_sh = [(1, 2), (1, 4), (1, 8), (2, 2), (2, 4), (4, 2),
                  (4, 1), (8, 1)][int(rs.integers(0, 8))]
    cfg = _draw_cfg(rs, channels=c_sh)
    mesh = make_mesh(jax.devices()[:c_sh * t_sh], channel_shards=c_sh,
                     time_shards=t_sh)
    sc = ShardedChain(cfg, mesh)
    raws = [_fuzz_raw(cfg, sc.in_wire_len, c_sh, rs) for _ in range(2)]

    carry = sc.init_carry()
    outs = []
    for raw in raws:
        carry, out = sc.step(carry, raw, np.False_)
        outs.append(np.asarray(out))
    got = np.concatenate(outs, axis=-1)

    want = _oracle_chain(cfg, sc.local.cfg.target_block, sc.n_in,
                         raws, t_sh)
    ref_dsp.assert_parity(got, want, (seed, cfg, (c_sh, t_sh)))
