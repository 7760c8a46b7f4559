"""Time/channel-sharded chain vs the single-device chain (8 CPU devices)."""

import jax
import numpy as np
import pytest

from iq_tool_tpu.ops.fir_design import FilterRequest
from iq_tool_tpu.parallel import ShardedChain, make_mesh
from iq_tool_tpu.pipeline.chain import Chain, ChainConfig
from tests import ref_dsp

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _full_cfg(channels=1, block=2048):
    return ChainConfig(
        input_format="cs16", output_format="cs16",
        input_rate=2_048_000.0, target_rate=1_488_375.0,
        channels=channels,
        dc_block=True,
        freq_shift_pre_hz=150_000.0,
        freq_shift_post_hz=-25_000.0,
        filters=[FilterRequest("lowpass", 400_000.0)],
        agc_profile="local",
        target_block=block,
    )


def _run_blocks(step_fn, init_carry, raws, reset_idx=None):
    carry = init_carry
    outs = []
    for i, raw in enumerate(raws):
        reset = np.bool_(reset_idx == i)
        carry, out = step_fn(carry, raw, reset)
        outs.append(np.asarray(jax.device_get(out)))
    return np.concatenate(outs, axis=-1)


def _make_raws(n_blocks, shape_frames, rng, items=2):
    return [rng.integers(-2 ** 14, 2 ** 14,
                         (1, shape_frames * items)).astype(np.int16)
            for _ in range(n_blocks)]


def test_time_sharded_matches_single(rng):
    mesh = make_mesh(jax.devices(), channel_shards=1, time_shards=8)
    cfg = _full_cfg(block=2048)
    sc = ShardedChain(cfg, mesh)
    single = Chain(ChainConfig(**{**cfg.__dict__,
                                  "target_block": sc.local.cfg.target_block}))
    # single chain at the per-shard block size: 8 single blocks == 1 sharded
    assert sc.n_in == 8 * single.n_in

    raws = _make_raws(2, sc.n_in, rng)
    got = _run_blocks(sc.step, sc.init_carry(), raws)

    carry = single.init_carry()
    outs = []
    for raw in raws:
        for j in range(8):
            sub = raw[:, j * single.n_in * 2:(j + 1) * single.n_in * 2]
            carry, out = single.step(carry, sub, np.False_)
            outs.append(np.asarray(jax.device_get(out)))
    want = np.concatenate(outs, axis=-1)

    # Quantized int16 outputs. Without the DC blocker the match is exact
    # (test_sharded_without_dc_is_exact); the DC IIR (10 Hz cutoff -> 32k
    # sample time constant, condition ~1/alpha = 3e4) legitimately amplifies
    # few-ulp f32 association differences to a few codes that then thread
    # through the AGC gain loop.  Compare at the SNR level (chain contract
    # is 60 dB) plus a hard cap on any single code.
    diff = got.astype(np.float64) - want.astype(np.float64)
    snr = 10 * np.log10((want.astype(np.float64) ** 2).mean()
                        / (diff ** 2).mean())
    assert snr > 60.0, snr
    assert np.abs(diff).max() <= 32


def test_channel_sharded_matches_single(rng):
    mesh = make_mesh(jax.devices(), channel_shards=4, time_shards=2)
    cfg = _full_cfg(channels=4, block=2048)
    sc = ShardedChain(cfg, mesh)
    raws = [rng.integers(-2 ** 14, 2 ** 14, (4, sc.n_in * 2)).astype(np.int16)
            for _ in range(2)]
    got = _run_blocks(sc.step, sc.init_carry(), raws)

    single = Chain(ChainConfig(**{**cfg.__dict__, "channels": 1,
                                  "target_block": sc.local.cfg.target_block}))
    for ch in range(0, 4, 3):   # spot-check first and last channel
        carry = single.init_carry()
        outs = []
        for raw in raws:
            for j in range(2):
                sub = raw[ch:ch + 1, j * single.n_in * 2:(j + 1) * single.n_in * 2]
                carry, out = single.step(carry, sub, np.False_)
                outs.append(np.asarray(jax.device_get(out)))
        want = np.concatenate(outs, axis=-1)[0]
        diff = got[ch].astype(np.float64) - want.astype(np.float64)
        snr = 10 * np.log10((want.astype(np.float64) ** 2).mean()
                            / ((diff ** 2).mean() + 1e-30))
        assert snr > 60.0, snr


def test_sharded_reset(rng):
    mesh = make_mesh(jax.devices(), channel_shards=1, time_shards=8)
    cfg = _full_cfg(block=2048)
    sc = ShardedChain(cfg, mesh)
    raws = _make_raws(2, sc.n_in, rng)
    carry = sc.init_carry()
    carry, _ = sc.step(carry, raws[0], np.False_)
    _, out_reset = sc.step(carry, raws[1], np.True_)
    _, out_fresh = sc.step(sc.init_carry(), raws[1], np.False_)
    np.testing.assert_array_equal(np.asarray(jax.device_get(out_reset)),
                                  np.asarray(jax.device_get(out_fresh)))


def test_sharded_tone_quality():
    """A tone through the full sharded chain keeps its fidelity."""
    mesh = make_mesh(jax.devices(), channel_shards=1, time_shards=8)
    cfg = ChainConfig(input_format="cs16", output_format="cs16",
                      input_rate=2_048_000.0, target_rate=1_488_375.0,
                      filters=[FilterRequest("lowpass", 400_000.0)],
                      target_block=2048)
    sc = ShardedChain(cfg, mesh)
    carry = sc.init_carry()
    outs = []
    for b in range(3):
        t = np.arange(b * sc.n_in, (b + 1) * sc.n_in) / 2_048_000.0
        x = (0.5 * np.exp(2j * np.pi * 100_000.0 * t)).astype(np.complex64)
        raw = ref_dsp.from_cf32(x, "cs16")[None, :]
        carry, out = sc.step(carry, raw, np.False_)
        outs.append(np.asarray(jax.device_get(out))[0])
    y = ref_dsp.to_cf32(np.concatenate(outs), "cs16")[sc.n_out:]
    m = np.arange(sc.n_out, 3 * sc.n_out)
    ideal = np.exp(2j * np.pi * (100_000.0 / 1_488_375.0) * m)
    a = np.vdot(ideal, y) / np.vdot(ideal, ideal)
    snr = 10 * np.log10(np.mean(np.abs(a * ideal) ** 2)
                        / np.mean(np.abs(y - a * ideal) ** 2))
    assert snr > 55.0
    assert abs(abs(a) - 0.5) < 0.01


def test_sharded_without_dc_is_exact(rng):
    """Everything except the DC IIR matches the single-device chain
    bit-for-bit after quantization."""
    mesh = make_mesh(jax.devices(), channel_shards=1, time_shards=8)
    cfg = ChainConfig(input_format="cs16", output_format="cs16",
                      input_rate=2_048_000.0, target_rate=1_488_375.0,
                      freq_shift_pre_hz=150_000.0,
                      filters=[FilterRequest("lowpass", 400_000.0)],
                      agc_profile="local", target_block=2048)
    sc = ShardedChain(cfg, mesh)
    single = Chain(ChainConfig(**{**cfg.__dict__,
                                  "target_block": sc.local.cfg.target_block}))
    raws = _make_raws(2, sc.n_in, rng)
    got = _run_blocks(sc.step, sc.init_carry(), raws)
    carry = single.init_carry()
    outs = []
    for raw in raws:
        for j in range(8):
            sub = raw[:, j * single.n_in * 2:(j + 1) * single.n_in * 2]
            carry, out = single.step(carry, sub, np.False_)
            outs.append(np.asarray(jax.device_get(out)))
    want = np.concatenate(outs, axis=-1)
    np.testing.assert_array_equal(got, want)


def test_sharded_dc_matches_exact_recurrence(rng):
    """The sharded DC blocker against the scalar double-precision oracle."""
    from iq_tool_tpu.ops import dc_block
    mesh = make_mesh(jax.devices(), channel_shards=1, time_shards=8)
    cfg = ChainConfig(input_format="cf32", output_format="cf32",
                      input_rate=100_000.0, dc_block=True, target_block=2048)
    sc = ShardedChain(cfg, mesh)
    n = sc.n_in
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    raw = np.empty((1, 2 * n), np.float32)
    raw[0, 0::2], raw[0, 1::2] = x.real, x.imag
    _, out = sc.step(sc.init_carry(), raw, np.False_)
    out = np.asarray(jax.device_get(out))[0]
    y = out[0::2] + 1j * out[1::2]
    alpha = dc_block.alpha_for_rate(100_000.0)
    a = 1.0 - alpha
    want = np.zeros(n, np.complex128)
    xp = 0.0
    yp = 0.0
    for i in range(n):
        want[i] = x[i] - xp + a * yp
        xp, yp = x[i], want[i]
    np.testing.assert_allclose(y, want, atol=3e-4)


def test_time_sharded_dft_engine_filter(rng):
    """A > 2048-tap stop-range rides the FFT overlap-save engine; its
    (C, block) overlap-save carry must flow across time shards like any
    other stateful stage.  1-code tolerance: shard-local FFT windows
    re-associate float reductions."""
    from iq_tool_tpu.parallel.sharded import ShardedChain, make_mesh
    cfg = ChainConfig(
        input_format="cs16", output_format="cs16",
        input_rate=2_048_000.0, target_rate=1_488_375.0,
        dc_block=True, freq_shift_pre_hz=100_000.0,
        filters=[FilterRequest("stop-range", 0.0, 10_000.0)],
        target_block=1 << 16)
    mesh = make_mesh(jax.devices()[:4], 1, 4)       # 4-way time sharding
    sc = ShardedChain(cfg, mesh)
    plain = Chain(ChainConfig(**{**cfg.__dict__,
                                 "target_block": sc.local.cfg.target_block}))
    assert not plain.post_filter._exec_banded        # FFT engine engaged
    raws = _make_raws(2, sc.n_in, rng)
    a = _run_blocks(sc.step, sc.init_carry(), raws).astype(np.int32)
    b = _run_blocks(plain.step, plain.init_carry(1), raws).astype(np.int32)
    d = np.abs(a - b)
    assert d.max() <= 1, d.max()
    assert (d != 0).mean() < 0.02


def _run_single_subblocks(cfg, sc, raws, t):
    """The plain single-device chain over the same stream, stepped at
    the per-shard block size (the ground truth for sharded runs)."""
    single = Chain(ChainConfig(**{**cfg.__dict__,
                                  "target_block": sc.local.cfg.target_block}))
    carry = single.init_carry()
    outs = []
    w = single.n_in * 2
    for raw in raws:
        for j in range(t):
            carry, out = single.step(carry, raw[:, j * w:(j + 1) * w],
                                     np.False_)
            outs.append(np.asarray(jax.device_get(out)))
    return np.concatenate(outs, axis=-1)


# Geometries the shard stitch must carry on a 1x4 time mesh: DC + I/Q
# correction + pre-NCO, a pre-NCO with the lowpass composed into a stage
# (no DC), a single-stage cascade, and the digital AGC's per-global-block
# peak (pmax over time shards).
STITCH_CASES = {
    "dc_iq_nco": dict(dc_block=True, iq_correction=True,
                      freq_shift_pre_hz=150_000.0,
                      filters=[FilterRequest("lowpass", 400_000.0)]),
    "nco_composed_lowpass": dict(freq_shift_pre_hz=250_000.0,
                                 filters=[FilterRequest("lowpass",
                                                        400_000.0)]),
    "single_stage_441_512": dict(target_rate=1_764_000.0),
    "flagship_post_nco_agc": dict(dc_block=True, freq_shift_pre_hz=150_000.0,
                                  freq_shift_post_hz=-25_000.0,
                                  filters=[FilterRequest("lowpass",
                                                         400_000.0)],
                                  agc_profile="local"),
}


@pytest.mark.parametrize("case", list(STITCH_CASES))
def test_time_sharded_stitch_matches_single(rng, case):
    """1x4 time-sharded chain vs the single-device chain stepped at the
    per-shard block: 60 dB SNR plus a code cap, exact without the DC
    IIR and the I/Q estimator."""
    kw = STITCH_CASES[case]
    cfg = ChainConfig(**{**dict(input_format="cs16", output_format="cs16",
                                input_rate=2_048_000.0,
                                target_rate=1_488_375.0, target_block=4096),
                         **kw})
    sc = ShardedChain(cfg, make_mesh(jax.devices()[:4], 1, 4))
    raws = _make_raws(3, sc.n_in, rng)
    got = _run_blocks(sc.step, sc.init_carry(), raws)
    want = _run_single_subblocks(cfg, sc, raws, 4)
    if not (cfg.dc_block or cfg.iq_correction):
        np.testing.assert_array_equal(got, want)
    diff = got.astype(np.float64) - want.astype(np.float64)
    snr = 10 * np.log10((want.astype(np.float64) ** 2).mean()
                        / ((diff ** 2).mean() + 1e-30))
    assert snr > 60.0, snr
    assert np.abs(diff).max() <= 32, np.abs(diff).max()


def test_sharded_reset_time_mesh(rng):
    """Discontinuity reset on a 1x4 time mesh equals a fresh start (the
    zeroed halo and DC carries feed the stitch correctly)."""
    mesh = make_mesh(jax.devices()[:4], channel_shards=1, time_shards=4)
    sc = ShardedChain(_full_cfg(block=4096), mesh)
    raws = _make_raws(2, sc.n_in, rng)
    carry = sc.init_carry()
    carry, _ = sc.step(carry, raws[0], np.False_)
    _, out_reset = sc.step(carry, raws[1], np.True_)
    _, out_fresh = sc.step(sc.init_carry(), raws[1], np.False_)
    np.testing.assert_array_equal(np.asarray(jax.device_get(out_reset)),
                                  np.asarray(jax.device_get(out_fresh)))


def test_sharded_digital_agc_matches_global_block(rng):
    """Digital AGC on a 1x4 time mesh: one peak-lock update per global
    block (pmax over shards), so the carried AgcState after each step
    equals the unsharded chain's at the global block size."""
    cfg = ChainConfig(input_format="cs16", output_format="cs16",
                      input_rate=2_048_000.0, target_rate=1_488_375.0,
                      freq_shift_post_hz=-25_000.0,
                      filters=[FilterRequest("lowpass", 400_000.0)],
                      agc_profile="digital", target_block=4096)
    sc = ShardedChain(cfg, make_mesh(jax.devices()[:4], 1, 4))
    big = Chain(ChainConfig(**{**cfg.__dict__, "target_block": sc.n_in}))
    assert big.n_in == sc.n_in
    raws = _make_raws(4, sc.n_in, rng)
    cs, cb = sc.init_carry(), big.init_carry()
    for raw in raws:
        cs, os_ = sc.step(cs, raw, np.False_)
        cb, ob = big.step(cb, raw, np.False_)
        sa, sb = jax.device_get(cs["agc"]), jax.device_get(cb["agc"])
        np.testing.assert_array_equal(np.asarray(sa.locked),
                                      np.asarray(sb.locked))
        np.testing.assert_allclose(np.asarray(sa.gain), np.asarray(sb.gain),
                                   rtol=1e-6)


def test_carry_struct_creates_no_eager_arrays(monkeypatch):
    """Constructing a ShardedChain and inspecting its carry struct/specs
    runs nothing on a device: the halo widths and leaf specs come from
    abstract evaluation only."""
    import jax.numpy as jnp

    eager = []
    orig = jnp.zeros

    def spy(*a, **k):
        r = orig(*a, **k)
        if not isinstance(r, jax.core.Tracer):
            eager.append((a, k))
        return r

    monkeypatch.setattr(jnp, "zeros", spy)
    cfg = ChainConfig(input_format="cs16", output_format="cs16",
                      input_rate=2_048_000.0, target_rate=1_488_375.0,
                      dc_block=True, freq_shift_pre_hz=100e3,
                      filters=[FilterRequest("lowpass", 400_000.0)])
    sc = ShardedChain(cfg, make_mesh(jax.devices()[:8], 1, 8))
    struct = sc._carry_struct()
    specs = sc.carry_specs()
    assert not eager, f"eager device arrays created: {eager}"
    assert set(struct) == set(specs)
    # halo widths still resolve to the real stage history sizes
    assert all(h > 0 for kind, h in struct.values() if kind == "halo")
