"""Output AGC: dx / local (RMS tracking) and digital (peak-lock) profiles.

Contract (src/agc.c, constants.h:164-192):

* dx/local: liquid agc_crcf RMS tracking toward target 0.5, loop bandwidth
  1e-4 (dx) / 1e-2 (local), gain initialized to 1.0 (agc.c:38-68).
* digital: custom peak-lock (agc.c:117-221) —
  PHASE A (scanning, first 2 s): monotonic peak memory (init 0.05),
  running gain = target/peak applied immediately; lock after 2 s.
  PHASE B (locked): per-block peak; clip (out_peak > 1.0) -> ratchet gain
  to 0.99/peak and reset hang timer; strong (> 75% target) -> reset hang
  timer; weak for > 4 s -> gain *= 1.0005 per block.  Default target 0.9.

Design: the digital profile is already block-granular scalar state ->
direct jnp.where state machine.  The dx/local per-sample multiplicative
loop is approximated at AGC_SEGMENT (=128 sample) granularity inside a
lax.scan: per segment, g *= (target^2 / e2_out)^(beta/2) with
beta = 1 - (1-bw)^L — the exact discrete-time aggregation of liquid's
per-sample one-pole loop under a constant-envelope segment.  Time-based
hang/lock windows use SAMPLE counts at the output rate (the reference uses
wall-clock, which only coincides with stream time for real-time SDR
sources; sample time is the faithful notion for faster-than-realtime file
processing).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from iq_tool_tpu import constants as C

PROFILES = ("dx", "local", "digital")


class AgcConfig(NamedTuple):
    profile: str
    target: float
    sample_rate: float      # output rate, for lock/hang sample windows

    @classmethod
    def make(cls, profile: str, sample_rate: float, target: float | None = None):
        if profile not in PROFILES:
            raise ValueError(f"unknown AGC profile '{profile}'; valid: {PROFILES}")
        if target is None or target <= 0:
            target = (C.AGC_DIGITAL_TARGET if profile == "digital"
                      else C.AGC_TARGET)
        return cls(profile, float(target), float(sample_rate))


class AgcState(NamedTuple):
    gain: jnp.ndarray         # (C,) f32 current gain
    e2: jnp.ndarray           # (C,) f32 smoothed output energy (dx/local)
    peak_mem: jnp.ndarray     # (C,) f32 scan-phase peak memory (digital)
    locked: jnp.ndarray       # (C,) bool
    samples_seen: jnp.ndarray  # (C,) uint32
    weak_run: jnp.ndarray     # (C,) uint32 samples since last strong peak


def init(channels: int) -> AgcState:
    return AgcState(
        gain=jnp.ones((channels,), jnp.float32),
        e2=jnp.zeros((channels,), jnp.float32),
        peak_mem=jnp.full((channels,), 0.05, jnp.float32),
        locked=jnp.zeros((channels,), bool),
        samples_seen=jnp.zeros((channels,), jnp.uint32),
        weak_run=jnp.zeros((channels,), jnp.uint32),
    )


def reset(state: AgcState) -> AgcState:
    """agc.c:225-238: gain->1, unlock, peak->0.05, counters->0."""
    return init(state.gain.shape[0])


def rms_scan(e_in: jnp.ndarray, gain: jnp.ndarray, e2: jnp.ndarray,
             beta: float, target: float):
    """The per-segment RMS gain loop: e_in (n_seg, C) mean input energies ->
    (gains (n_seg, C), final gain, final e2).  Exposed separately so the
    time-sharded path can run the identical scan over all-gathered
    segment energies (exact cross-shard semantics)."""
    beta = jnp.float32(beta)
    t2 = jnp.float32(target * target)

    def body(carry, e_seg):
        g, e2_ = carry
        e_out = e_seg * g * g
        e2_new = (1.0 - beta) * e2_ + beta * e_out
        g_new = g * jnp.exp(-0.5 * beta * jnp.log(
            jnp.maximum(e2_new, 1e-16) / t2))
        # digital silence would otherwise drive g -> inf, then 0*inf = NaN
        # permanently poisons the state; clamp like a real AGC's gain range
        g_new = jnp.clip(g_new, 1e-6, 1e6)
        return (g_new, e2_new), g_new

    # ~1500 segments/block at the default geometry: the body is a handful
    # of elementwise ops on (C,) vectors, so loop-iteration overhead
    # dominates — unrolling packs 16 updates per XLA while-iteration
    # (identical math, same order)
    (g_fin, e2_fin), gains = jax.lax.scan(body, (gain, e2), e_in, unroll=16)
    return gains, g_fin, e2_fin


def rms_params(cfg: AgcConfig, n: int) -> tuple[int, int, float]:
    """(n_seg, seg_len, beta) for a block of n samples."""
    bw = C.AGC_BW_DX if cfg.profile == "dx" else C.AGC_BW_LOCAL
    seg = C.AGC_SEGMENT
    n_seg = max(n // seg, 1)
    seg = n // n_seg
    beta = float(1.0 - (1.0 - bw) ** seg)
    return n_seg, seg, beta


def rms_gains(xr: jnp.ndarray, xi: jnp.ndarray, state: AgcState,
              cfg: AgcConfig):
    """(gains (C, n_seg), seg, new_state): the per-segment gain schedule
    for a block."""
    c, n = xr.shape
    n_seg, seg, beta = rms_params(cfg, n)
    xsr = xr[:, : n_seg * seg].reshape(c, n_seg, seg)
    xsi = xi[:, : n_seg * seg].reshape(c, n_seg, seg)
    e_in = jnp.mean(xsr * xsr + xsi * xsi, axis=-1).T  # (n_seg, C)
    gains, g_fin, e2_fin = rms_scan(e_in, state.gain, state.e2, beta,
                                    cfg.target)
    new_state = state._replace(gain=g_fin, e2=e2_fin,
                               samples_seen=state.samples_seen + jnp.uint32(n))
    return gains.T, seg, new_state


def _apply_rms_planar(xr: jnp.ndarray, xi: jnp.ndarray, state: AgcState,
                      cfg: AgcConfig):
    c, n = xr.shape
    gains, seg, new_state = rms_gains(xr, xi, state, cfg)
    n_seg = gains.shape[-1]
    gseg = gains[:, :, None]
    xsr = xr[:, : n_seg * seg].reshape(c, n_seg, seg)
    xsi = xi[:, : n_seg * seg].reshape(c, n_seg, seg)
    yr = (xsr * gseg).reshape(c, n_seg * seg)
    yi = (xsi * gseg).reshape(c, n_seg * seg)
    if n_seg * seg < n:  # ragged tail (only for tiny blocks)
        g_fin = new_state.gain
        yr = jnp.concatenate([yr, xr[:, n_seg * seg:] * g_fin[:, None]], axis=-1)
        yi = jnp.concatenate([yi, xi[:, n_seg * seg:] * g_fin[:, None]], axis=-1)
    return yr, yi, new_state


def digital_update(state: AgcState, block_peak: jnp.ndarray, n: int,
                   cfg: AgcConfig):
    """The digital-profile per-block state machine given the block peak
    (exposed so the time-sharded path can feed a pmax'd global peak).
    Returns (gain_to_apply (C,), new_state)."""
    target = jnp.float32(cfg.target)
    lock_samples = jnp.uint32(int(C.AGC_DIGITAL_SCAN_SEC * cfg.sample_rate))
    hang_samples = jnp.uint32(int(C.AGC_DIGITAL_HANG_SEC * cfg.sample_rate))

    # PHASE A (scanning)
    peak_mem_a = jnp.maximum(state.peak_mem, block_peak)
    safe_peak = jnp.maximum(peak_mem_a, 1e-4)
    running_gain = target / safe_peak
    elapsed = state.samples_seen
    lock_now = elapsed > lock_samples

    # PHASE B (locked)
    g = state.gain
    out_peak = block_peak * g
    clip = out_peak > 1.0
    g_ratchet = jnp.float32(C.AGC_DIGITAL_CLIP_RATCHET) / jnp.maximum(block_peak, 1e-9)
    strong = out_peak > target * jnp.float32(C.AGC_DIGITAL_CREEP_THRESH)
    weak_run_b = jnp.where(clip | strong, jnp.uint32(0),
                           state.weak_run + jnp.uint32(n))
    creep = (~clip) & (~strong) & (state.weak_run > hang_samples)
    g_b = jnp.where(clip, g_ratchet,
                    jnp.where(creep, g * jnp.float32(C.AGC_DIGITAL_CREEP), g))

    locked = state.locked
    gain_out = jnp.where(locked, g_b, running_gain)
    new_locked = locked | lock_now
    new_gain = jnp.where(locked, g_b,
                         jnp.where(lock_now, running_gain, state.gain))
    new_peak = jnp.where(locked, state.peak_mem, peak_mem_a)
    new_weak = jnp.where(locked, weak_run_b, jnp.uint32(0))

    new_state = AgcState(gain=new_gain, e2=state.e2, peak_mem=new_peak,
                         locked=new_locked,
                         samples_seen=state.samples_seen + jnp.uint32(n),
                         weak_run=new_weak)
    return gain_out, new_state


def _apply_digital_planar(xr: jnp.ndarray, xi: jnp.ndarray, state: AgcState,
                          cfg: AgcConfig):
    n = xr.shape[-1]
    block_peak = jnp.sqrt(jnp.max(xr * xr + xi * xi, axis=-1))   # (C,)
    gain_out, new_state = digital_update(state, block_peak, n, cfg)
    g = gain_out[:, None]
    return xr * g, xi * g, new_state


def apply_planar(xr: jnp.ndarray, xi: jnp.ndarray, state: AgcState,
                 cfg: AgcConfig):
    """Planar f32 planes (C, N) -> (yr, yi, new state)."""
    if cfg.profile == "digital":
        return _apply_digital_planar(xr, xi, state, cfg)
    return _apply_rms_planar(xr, xi, state, cfg)


def apply(x: jnp.ndarray, state: AgcState, cfg: AgcConfig):
    """x: (C, N) complex64 -> (y, new state)."""
    yr, yi, ns = apply_planar(jnp.real(x), jnp.imag(x), state, cfg)
    return jax.lax.complex(yr, yi).astype(jnp.complex64), ns
