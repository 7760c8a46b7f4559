"""Post stage through Chain.step — post NCO, AGC, quantize — against a
float64 numpy model of the same contracts (frequency_shift.c, agc.c,
sample_convert.c via tests/ref_dsp.py)."""

import numpy as np
import pytest

from iq_tool_tpu import constants as C
from iq_tool_tpu.pipeline.chain import Chain, ChainConfig
from tests import ref_dsp

RATE = 16384.0          # 1 s blocks: the digital profile locks after 2 s
N = 16384
SHIFT = 1500.0


def _nco(x, start):
    step = round((SHIFT / RATE) % 1.0 * 2 ** 32)
    k = np.arange(start, start + x.shape[-1], dtype=np.uint64)
    ph = (k * np.uint64(step)) % (1 << 32)
    return x * np.exp(2j * np.pi * ph.astype(np.float64) / 2 ** 32)


def _rms_agc(x, state, profile):
    bw = C.AGC_BW_DX if profile == "dx" else C.AGC_BW_LOCAL
    seg = C.AGC_SEGMENT
    beta = 1.0 - (1.0 - bw) ** seg
    g, e2 = state
    y = np.empty_like(x)
    for k in range(x.shape[-1] // seg):
        xs = x[:, k * seg:(k + 1) * seg]
        e2 = (1 - beta) * e2 + beta * np.mean(np.abs(xs) ** 2, -1) * g * g
        g = np.clip(g * np.exp(-0.5 * beta * np.log(
            np.maximum(e2, 1e-16) / C.AGC_TARGET ** 2)), 1e-6, 1e6)
        y[:, k * seg:(k + 1) * seg] = xs * g[:, None]
    return y, (g, e2)


def _digital_agc(x_pre, x, state):
    """agc.c:117-221, one update per block and channel; the peak is taken
    before the post NCO."""
    g, peak_mem, locked, seen, weak = state
    target = C.AGC_DIGITAL_TARGET
    n = x.shape[-1]
    peak = np.abs(x_pre).max(-1)
    lock_now = seen > int(C.AGC_DIGITAL_SCAN_SEC * RATE)
    out = g.copy()
    for c in range(len(g)):
        if locked[c]:
            clip = peak[c] * g[c] > 1.0
            strong = peak[c] * g[c] > target * C.AGC_DIGITAL_CREEP_THRESH
            creep = not clip and not strong and weak[c] > int(
                C.AGC_DIGITAL_HANG_SEC * RATE)
            if clip:
                g[c] = C.AGC_DIGITAL_CLIP_RATCHET / peak[c]
            elif creep:
                g[c] *= C.AGC_DIGITAL_CREEP
            weak[c] = 0 if (clip or strong) else weak[c] + n
            out[c] = g[c]
        else:
            peak_mem[c] = max(peak_mem[c], peak[c])
            out[c] = target / max(peak_mem[c], 1e-4)
            if lock_now:
                locked[c], g[c] = True, out[c]
    return x * out[:, None], (g, peak_mem, locked, seen + n, weak)


@pytest.mark.parametrize("fmt", ["cs16", "cu8", "cs8", "sc16q11"])
@pytest.mark.parametrize("profile", [None, "local", "dx", "digital"])
def test_post_stage_matches_model(rng, profile, fmt):
    cfg = ChainConfig(input_format="cf32", output_format=fmt,
                      input_rate=RATE, target_rate=None, channels=2,
                      freq_shift_post_hz=SHIFT, agc_profile=profile,
                      target_block=N)
    chain = Chain(cfg)
    assert chain.n_in == N
    amp = np.array([[0.2], [0.05]])
    t = np.arange(5 * N) / RATE
    x = (amp * np.exp(2j * np.pi * 700.0 * t)
         + 0.01 * (rng.standard_normal((2, 5 * N))
                   + 1j * rng.standard_normal((2, 5 * N))))
    x = x.astype(np.complex64)
    carry = chain.init_carry()
    state = ((np.ones(2), np.zeros(2)) if profile in ("local", "dx")
             else (np.ones(2), np.full(2, 0.05), [False, False], 0,
                   [0, 0]))
    for b in range(5):
        xb = x[:, b * N:(b + 1) * N]
        wire = np.stack([ref_dsp.from_cf32(xb[c], "cf32") for c in range(2)])
        carry, out = chain.step(carry, wire, np.False_)
        y = _nco(xb.astype(np.complex128), b * N)
        if profile == "digital":
            y, state = _digital_agc(xb, y, state)
        elif profile:
            y, state = _rms_agc(y, state, profile)
        want = np.stack([ref_dsp.from_cf32(y[c], fmt) for c in range(2)])
        d = np.abs(np.asarray(out).astype(np.int64) - want.astype(np.int64))
        assert d.max() <= 1, (b, d.max())
        # float32 chain vs float64 model: ~5e-7 relative, i.e. up to
        # ~0.02 code at full scale, so a sample rounds to the neighbouring
        # code only within that distance of a half-code boundary
        assert (d != 0).mean() < 5e-2, (b, (d != 0).mean())
