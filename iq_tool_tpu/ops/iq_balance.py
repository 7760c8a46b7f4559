"""I/Q imbalance correction and estimation.

Contract (src/iq_correct.c, SDR#-derived, MIT provenance noted at
iq_correct.c:20-50):

* apply:  I' = (1+g)*I ;  Q' = Q + phi*I            (iq_correct.c:307-313)
* estimate: Hamming-windowed 1024-pt FFT -> fftshift -> dB power spectrum
  (:315-336); utility = sum over the 5%..95% bin band of
  (P(+f) - P(-f))^2 where either side is above -80 dB (:338-359) — the
  utility is MAXIMIZED (balanced signals have maximal spectral asymmetry
  because the mirror image vanishes); gated on peak-to-average >= 20 dB
  (:362-388); rate-limited to 500 ms; result EMA-smoothed with factor 0.05
  (:206-216).

Redesign of the search: the reference walks 25 random +-1e-4 diagonal
steps (iq_correct.c:191-201, _get_random_direction).  Because the
correction is LINEAR in the factors —

    corrected = x + (g + i*phi) * Re(x)
    FFT(w * corrected) = FFT(w*x) + (g + i*phi) * FFT(w*Re(x))

— we compute the two FFTs once per update and then evaluate each candidate
spectrum with a fused multiply-add, making candidate evaluation ~1000x
cheaper than re-running the FFT.  We replace the random walk with a
deterministic greedy descent over the same +-step diagonal moves
(best-of-4 each iteration, 25 iterations), which dominates the reference's
random walk in utility while being reproducible and jit-friendly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from iq_tool_tpu import constants as C


class IqState(NamedTuple):
    factors: jnp.ndarray            # (C, 2) float32: [gain, phase]
    samples_since_opt: jnp.ndarray  # () uint32, saturating counter


def init(channels: int) -> IqState:
    return IqState(
        factors=jnp.zeros((channels, 2), jnp.float32),
        samples_since_opt=jnp.asarray(0xFFFFFFFF, jnp.uint32),  # fire ASAP
    )


def reset(state: IqState) -> IqState:
    # Discontinuity: the reference keeps learned factors (only DSP with
    # internal sample memory resets); mirror that.
    return state


def apply_planar(xr: jnp.ndarray, xi: jnp.ndarray, factors: jnp.ndarray):
    """Planar SDR# correction: I' = (1+g)I, Q' = Q + phi*I
    (iq_correct.c:307-313)."""
    g = factors[:, 0:1]
    phi = factors[:, 1:2]
    return xr * (1.0 + g), xi + phi * xr


def apply(x: jnp.ndarray, factors: jnp.ndarray) -> jnp.ndarray:
    """x: (C, N) complex64; factors: (C, 2) -> corrected block."""
    yr, yi = apply_planar(jnp.real(x), jnp.imag(x), factors)
    return jax.lax.complex(yr, yi).astype(jnp.complex64)


def _hamming(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float32)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1))).astype(np.float32)


_WINDOW = None


def _window(n: int) -> np.ndarray:
    global _WINDOW
    if _WINDOW is None or _WINDOW.shape[0] != n:
        _WINDOW = _hamming(n)   # numpy: embeds as a jit literal
    return _WINDOW


def _shifted_fft(x: jnp.ndarray) -> jnp.ndarray:
    """fftshift(FFT(x)) over the last axis, complex64."""
    return jnp.fft.fftshift(jnp.fft.fft(x.astype(jnp.complex64)), axes=-1)


def _spectrum_db(base: jnp.ndarray, image: jnp.ndarray, g: jnp.ndarray,
                 phi: jnp.ndarray) -> jnp.ndarray:
    """dB spectrum of the corrected signal from precomputed FFTs.

    base = fftshift(FFT(w*x)), image = fftshift(FFT(w*Re(x))); g/phi may
    carry leading batch dims.
    """
    k = (g + 1j * phi).astype(jnp.complex64)
    spec = base + k[..., None] * image
    mag = jnp.abs(spec) / jnp.float32(base.shape[-1])
    return 20.0 * jnp.log10(mag + 1e-12)


def _utility(spec_db: jnp.ndarray) -> jnp.ndarray:
    """iq_correct.c:338-359 on an fftshifted dB spectrum (last axis)."""
    nfft = spec_db.shape[-1]
    half = nfft // 2
    lo = int(C.IQ_BAND_LO * half)
    hi = int(C.IQ_BAND_HI * half)
    p_neg = spec_db[..., lo:hi]
    # p_pos[i] = spec[nfft-1-i] for i in [lo, hi)  (iq_correct.c:350-352)
    p_pos = jnp.flip(spec_db[..., nfft - hi: nfft - lo], axis=-1)
    d = p_pos - p_neg
    mask = (p_pos > C.IQ_SPECTRUM_FLOOR_DB) | (p_neg > C.IQ_SPECTRUM_FLOOR_DB)
    return jnp.sum(jnp.where(mask, d * d, 0.0), axis=-1)


def _power_gate(spec_db: jnp.ndarray) -> jnp.ndarray:
    """peak-to-average over the utility band (iq_correct.c:362-388)."""
    nfft = spec_db.shape[-1]
    half = nfft // 2
    lo = int(C.IQ_BAND_LO * half)
    hi = int(C.IQ_BAND_HI * half)
    p_neg = spec_db[..., lo:hi]
    p_pos = jnp.flip(spec_db[..., nfft - hi: nfft - lo], axis=-1)
    mx = jnp.maximum(jnp.max(p_pos, axis=-1), jnp.max(p_neg, axis=-1))
    avg = (jnp.sum(p_pos, axis=-1) + jnp.sum(p_neg, axis=-1)) / (2.0 * (hi - lo))
    return mx - avg


# the 4 diagonal candidate directions of the reference's random walk
_DIRS = np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]], np.float32)


def _optimize_channel(x: jnp.ndarray, factors: jnp.ndarray,
                      passes: int = 25) -> jnp.ndarray:
    """Greedy diagonal descent for one channel.

    x: (nfft,) complex64 (first IQ_FFT_SIZE samples of the block);
    factors: (2,) -> new (2,) factors (unsmoothed).
    """
    nfft = x.shape[-1]
    w = _window(nfft)
    base = _shifted_fft(w * x)
    image = _shifted_fft(w * jnp.real(x))
    return _optimize_core(base, image, factors, passes)


def _optimize_core(base: jnp.ndarray, image: jnp.ndarray,
                   factors: jnp.ndarray, passes: int = 25) -> jnp.ndarray:
    """The descent given precomputed base/image spectra (one channel)."""
    step = jnp.float32(C.IQ_EST_STEP)
    dirs = jnp.asarray(_DIRS)

    def body(carry, _):
        cur, cur_u = carry
        cands = cur[None, :] + step * dirs              # (4, 2)
        spec = _spectrum_db(base, image, cands[:, 0], cands[:, 1])
        us = _utility(spec)                             # (4,)
        best = jnp.argmax(us)
        better = us[best] > cur_u
        new = jnp.where(better, cands[best], cur)
        new_u = jnp.where(better, us[best], cur_u)
        return (new, new_u), None

    u0 = _utility(_spectrum_db(base, image, factors[0], factors[1]))
    (out, _), _ = jax.lax.scan(body, (factors, u0), None, length=passes)
    return out


def maybe_update_planar(xr: jnp.ndarray, xi: jnp.ndarray, state: IqState,
                        interval_samples: int, passes: int = 25,
                        advance_samples: int | None = None) -> IqState:
    """Planar wrapper: only the first IQ_FFT_SIZE samples feed the
    estimator, so the complex view is built over that slice alone."""
    n = xr.shape[-1]
    m = min(n, C.IQ_FFT_SIZE)
    seg = jax.lax.complex(xr[:, :m], xi[:, :m]).astype(jnp.complex64)
    return maybe_update(seg, state, interval_samples, passes,
                        advance_samples=(n if advance_samples is None
                                         else advance_samples))


def maybe_update(x: jnp.ndarray, state: IqState, interval_samples: int,
                 passes: int = 25, advance_samples: int | None = None) -> IqState:
    """Run the rate-limited, power-gated estimator on a block.

    x: (C, N) complex64 — the *pre-correction* block (the reference taps the
    converted+DC-blocked signal before correction is re-estimated,
    pipeline.c:468-476 feeds post-chain copies; we tap pre-apply which is
    equivalent at convergence).  Uses the first IQ_FFT_SIZE samples.
    """
    nfft = C.IQ_FFT_SIZE
    n = x.shape[-1]
    seg = x[:, :nfft] if n >= nfft else jnp.pad(x, ((0, 0), (0, nfft - n)))

    counter = state.samples_since_opt
    due = counter >= jnp.uint32(interval_samples)

    def run_estimator(factors):
        """FFTs + power gate + 25-pass descent — only on due blocks
        (lax.cond: ~99% of blocks skip the whole estimator instead of
        computing-and-discarding it)."""
        w = _window(nfft)
        base = _shifted_fft(w * seg)
        image = _shifted_fft(w * jnp.real(seg))
        spec0 = _spectrum_db(base, image, factors[:, 0], factors[:, 1])
        gate = _power_gate(spec0) >= jnp.float32(C.IQ_POWER_GATE_DB)  # (C,)
        new_raw = jax.vmap(
            lambda b, i, f: _optimize_core(b, i, f, passes))(
                base, image, factors)
        sm = jnp.float32(C.IQ_SMOOTHING)
        smoothed = (1.0 - sm) * factors + sm * new_raw
        return jnp.where(gate[:, None], smoothed, factors), jnp.any(gate)

    factors, ran = jax.lax.cond(
        due, run_estimator,
        lambda f: (f, jnp.bool_(False)), state.factors)
    # counter: reset when an update ran (any channel due+gated keeps the
    # reference's global 500 ms cadence), else saturating add (saturate
    # BEFORE adding so the 0xFFFFFFFF fire-ASAP sentinel cannot wrap)
    adv = jnp.uint32(advance_samples if advance_samples is not None else n)
    sat = jnp.uint32(0xF0000000)
    new_counter = jnp.where(ran, jnp.uint32(0),
                            jnp.minimum(jnp.minimum(counter, sat) + adv, sat))
    return IqState(factors=factors, samples_since_opt=new_counter)


def calibrate(x: jnp.ndarray, rounds: int = 10, passes: int = 25) -> jnp.ndarray:
    """Synchronous pre-stream calibration (files), iq_correct.c:237-302.

    x: (C, nfft) complex64 -> (C, 2) factors.  Runs several greedy rounds
    to convergence (the reference loops passes until the metric stops
    improving); smoothing is not applied here.
    """
    factors = jnp.zeros((x.shape[0], 2), jnp.float32)
    for _ in range(rounds):
        factors = jax.vmap(lambda xs, f: _optimize_channel(xs, f, passes))(
            x[:, :C.IQ_FFT_SIZE], factors)
    return factors
