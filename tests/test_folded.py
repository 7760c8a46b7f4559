"""Time-folded chain vs the sequential row-block chain.

Equivalence contract: without the DC blocker the only deltas are
batched-matmul re-association — the same +-1-code-on-<0.1%-of-samples
delta that batched C>1 channels show against C=1 runs — so we assert
max |diff| <= 1 code on < 0.1% of samples.
With the DC blocker, its f32 association differences may move a few
codes (60 dB SNR + code cap, as in tests/test_sharded.py)."""

import jax
import numpy as np
import pytest

from iq_tool_tpu.ops.fir_design import FilterRequest
from iq_tool_tpu.pipeline.chain import Chain, ChainConfig
from iq_tool_tpu.pipeline.folded import FoldedChain


def _cfg(channels=1, block=2048, dc=True, **kw):
    base = dict(
        input_format="cs16", output_format="cs16",
        input_rate=2_048_000.0, target_rate=1_488_375.0,
        channels=channels, dc_block=dc,
        freq_shift_pre_hz=150_000.0, freq_shift_post_hz=-25_000.0,
        filters=[FilterRequest("lowpass", 400_000.0)],
        agc_profile="local", target_block=block)
    base.update(kw)
    return ChainConfig(**base)


def _sequential(cfg, raws, fold, reset_idx=None):
    """Reference: the row-block chain fed each folded block in F slices."""
    single = Chain(cfg)
    carry = single.init_carry()
    outs = []
    w = single.in_wire_len
    for i, raw in enumerate(raws):
        for j in range(fold):
            reset = np.bool_(reset_idx == i and j == 0)
            carry, out = single.step(carry, raw[:, j * w:(j + 1) * w], reset)
            outs.append(np.asarray(jax.device_get(out)))
    return np.concatenate(outs, axis=-1)


def _run_folded(fc, raws, reset_idx=None):
    carry = fc.init_carry()
    outs = []
    for i, raw in enumerate(raws):
        carry, out = fc.step(carry, raw, np.bool_(reset_idx == i))
        outs.append(np.asarray(jax.device_get(out)))
    return np.concatenate(outs, axis=-1)


def _raws(n_blocks, fc, rng):
    return [rng.integers(-2 ** 14, 2 ** 14,
                         (fc.channels, fc.in_wire_len)).astype(np.int16)
            for _ in range(n_blocks)]


def _assert_codes(got, want, max_code=1, frac=1e-3):
    diff = got.astype(np.int32) - want.astype(np.int32)
    assert np.abs(diff).max() <= max_code, np.abs(diff).max()
    assert (diff != 0).mean() < frac, (diff != 0).mean()


def test_folded_without_dc_within_one_code(rng):
    cfg = _cfg(dc=False)
    fc = FoldedChain(cfg, fold=8)
    raws = _raws(3, fc, rng)
    got = _run_folded(fc, raws)
    want = _sequential(cfg, raws, 8)
    _assert_codes(got, want)


def test_folded_full_chain_snr(rng):
    cfg = _cfg(dc=True)
    fc = FoldedChain(cfg, fold=8)
    raws = _raws(3, fc, rng)
    got = _run_folded(fc, raws)
    want = _sequential(cfg, raws, 8)
    diff = got.astype(np.float64) - want.astype(np.float64)
    snr = 10 * np.log10((want.astype(np.float64) ** 2).mean()
                        / ((diff ** 2).mean() + 1e-30))
    assert snr > 60.0, snr
    assert np.abs(diff).max() <= 32


def test_folded_multichannel(rng):
    cfg = _cfg(channels=2, dc=False)
    fc = FoldedChain(cfg, fold=4)
    raws = _raws(2, fc, rng)
    got = _run_folded(fc, raws)
    want = _sequential(cfg, raws, 4)
    _assert_codes(got, want)


def test_folded_reset_propagation(rng):
    cfg = _cfg(dc=False)
    fc = FoldedChain(cfg, fold=8)
    raws = _raws(3, fc, rng)
    got = _run_folded(fc, raws, reset_idx=1)
    want = _sequential(cfg, raws, 8, reset_idx=1)
    _assert_codes(got, want)


def test_folded_digital_agc_semantics(rng):
    """Digital profile: one peak-lock update per folded step (the
    sharded path's per-global-block semantics) — must match the unfolded
    chain at the global block size at the SNR level."""
    cfg = _cfg(dc=False, agc_profile="digital")
    fc = FoldedChain(cfg, fold=8)
    big = Chain(ChainConfig(**{**cfg.__dict__,
                               "target_block": fc.n_in}))
    assert big.n_in == fc.n_in
    raws = _raws(3, fc, rng)
    got = _run_folded(fc, raws)
    carry = big.init_carry()
    outs = []
    for raw in raws:
        carry, out = big.step(carry, raw, np.False_)
        outs.append(np.asarray(jax.device_get(out)))
    want = np.concatenate(outs, axis=-1)
    diff = got.astype(np.float64) - want.astype(np.float64)
    snr = 10 * np.log10((want.astype(np.float64) ** 2).mean()
                        / ((diff ** 2).mean() + 1e-30))
    assert snr > 60.0, snr


def test_folded_cli_e2e(tmp_path, rng):
    """--time-fold 8 through the real CLI: output equals the unfolded run
    within the batching contract, exact frame accounting."""
    from iq_tool_tpu.cli import main

    n = 300_000
    inp = tmp_path / "in.raw"
    raw = rng.integers(-2 ** 14, 2 ** 14, 2 * n).astype(np.int16)
    raw.tofile(str(inp))
    argv = ["-i", "raw-file", "-o", "raw",
            "--raw-file-input-rate", "2048000",
            "--raw-file-input-sample-format", "cs16",
            "--output-rate", "1488375", "--output-sample-format", "cs16",
            "--freq-shift", "-100e3", "--lowpass", "400000",
            "--force-overwrite"]
    out_f = tmp_path / "folded.raw"
    out_u = tmp_path / "plain.raw"
    assert main(argv + ["--time-fold", "8", str(inp), str(out_f)]) == 0
    assert main(argv + ["--time-fold", "1", str(inp), str(out_u)]) == 0
    a = np.fromfile(str(out_f), np.int16)
    b = np.fromfile(str(out_u), np.int16)
    assert len(a) == len(b) == 2 * (n * 11907 // 16384)
    _assert_codes(a, b)


def test_folded_rejects_tail_wider_than_row(rng):
    """A carried tail wider than the row block (valid unfolded) must be
    rejected at CONSTRUCTION with a clear error."""
    from iq_tool_tpu.ops.fir_design import FilterRequest
    from iq_tool_tpu.pipeline.chain import ChainConfig

    cfg = ChainConfig(input_format="cs16", output_format="cs16",
                      input_rate=2_048_000.0, target_rate=None,
                      filters=[FilterRequest("lowpass", 400_000.0)],
                      filter_method="fir", filter_taps=3001,
                      target_block=2048)
    with pytest.raises(ValueError, match="time-fold"):
        FoldedChain(cfg, fold=8)


def test_cli_time_fold_conflicts_with_mesh(tmp_path, rng):
    from iq_tool_tpu.cli import main

    inp = tmp_path / "in.raw"
    rng.integers(-100, 100, 4096).astype(np.int16).tofile(str(inp))
    rc = main(["-i", "raw-file", "-o", "raw", str(inp),
               str(tmp_path / "out.raw"),
               "--raw-file-input-rate", "2048000",
               "--raw-file-input-sample-format", "cs16",
               "--output-rate", "1488375", "--output-sample-format", "cs16",
               "--mesh-time", "2", "--time-fold", "8", "--force-overwrite"])
    assert rc != 0


def test_checkpoint_interchange_folded_unfolded(tmp_path, rng):
    """A checkpoint from an unfolded run resumes under --time-fold 8 (the
    carry pytree is the row-block chain's carry in both), and the result
    matches the uninterrupted run within the batching contract."""
    from iq_tool_tpu.cli import main

    n = 16384 * 4
    i = np.arange(n, dtype=np.float64)
    x = 0.4 * np.exp(2j * np.pi * 80e3 * i / 2.048e6)
    raw = np.empty(2 * n, np.int16)
    raw[0::2] = np.rint(32767 * x.real)
    raw[1::2] = np.rint(32767 * x.imag)
    inp = tmp_path / "in.raw"
    raw.tofile(str(inp))
    base = ["-i", "raw-file", "-o", "raw",
            "--raw-file-input-rate", "2048000",
            "--raw-file-input-sample-format", "cs16",
            "--output-rate", "1488375", "--dc-block",
            "--freq-shift", "30e3", "--lowpass", "400e3",
            "--force-overwrite"]

    full = tmp_path / "full.raw"
    assert main(base + ["--time-fold", "1", str(inp), str(full)]) == 0

    cut = 16384 * 2 + 5000
    half_in = tmp_path / "half.raw"
    half_in.write_bytes(inp.read_bytes()[: cut * 4])
    part = tmp_path / "part.raw"
    ckpt = tmp_path / "state.ckpt"
    assert main(base + ["--time-fold", "1", str(half_in), str(part),
                        "--checkpoint", str(ckpt)]) == 0
    # resume the rest FOLDED
    assert main(base + ["--time-fold", "8", str(inp), str(part),
                        "--checkpoint", str(ckpt), "--resume"]) == 0
    a = np.frombuffer(part.read_bytes(), np.int16)
    b = np.frombuffer(full.read_bytes(), np.int16)
    assert len(a) == len(b)
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    # folded vs unfolded: batching re-association + DC IIR association
    assert d.max() <= 32 and (d != 0).mean() < 0.01


# Geometries the fold stitch must carry: post NCO + AGC, single- and
# multi-stage cascades, a post FIR too long to compose into a stage, a
# pre-NCO with the lowpass composed, DC + I/Q correction, and C=2 with DC.
STITCH_CASES = {
    "post_nco_agc": (dict(dc=False), 8),
    "single_stage_441_512": (dict(dc=False, target_rate=1_764_000.0,
                                  freq_shift_pre_hz=0.0,
                                  freq_shift_post_hz=0.0, filters=[],
                                  agc_profile=None, block=4096), 8),
    "two_stage_896k": (dict(dc=False, target_rate=896_000.0,
                            freq_shift_pre_hz=0.0, freq_shift_post_hz=0.0,
                            filters=[], agc_profile=None, block=8192), 8),
    "post_fir_301": (dict(dc=False, target_rate=1_024_000.0,
                          freq_shift_pre_hz=100_000.0,
                          freq_shift_post_hz=0.0,
                          filters=[FilterRequest("lowpass", 300_000.0)],
                          filter_taps=301, agc_profile=None, block=4096), 8),
    "pre_nco_composed_lowpass": (dict(dc=False, freq_shift_pre_hz=250_000.0,
                                      freq_shift_post_hz=0.0,
                                      agc_profile=None), 8),
    "dc_iq": (dict(dc=True, iq_correction=True), 8),
    "dc_two_channels": (dict(dc=True, channels=2, block=4096), 4),
}


@pytest.mark.parametrize("case", list(STITCH_CASES))
def test_folded_matches_sequential(rng, case):
    """FoldedChain vs the row-block chain fed the same stream in F
    slices: 60 dB SNR plus a code cap (exact up to re-association
    without the DC IIR)."""
    kw, fold = STITCH_CASES[case]
    cfg = _cfg(**kw)
    fc = FoldedChain(cfg, fold=fold)
    raws = _raws(2, fc, rng)
    got = _run_folded(fc, raws)
    want = _sequential(cfg, raws, fold)
    diff = got.astype(np.float64) - want.astype(np.float64)
    snr = 10 * np.log10((want.astype(np.float64) ** 2).mean()
                        / ((diff ** 2).mean() + 1e-30))
    assert snr > 60.0, snr
    assert np.abs(diff).max() <= (32 if cfg.dc_block else 1)
