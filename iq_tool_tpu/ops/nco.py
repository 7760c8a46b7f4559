"""NCO complex mixer (frequency shift).

Reference behavior (src/frequency_shift.c): one NCO pre-resample and/or one
post-resample; frequency = 2*pi*|shift|/rate with direction by sign
(frequency_shift.c:48-96); discontinuity reset zeroes phase but keeps
frequency (frequency_shift.c:102-107); sanity bound |shift| <= 5*rate
(constants.h:247).

Design: liquid's nco_crcf keeps a 32-bit fixed-point phase; we do the
same, but compute the whole block's phases in closed form instead of a
per-sample recurrence:  phase_u32[n] = acc + n * dtheta_u32  (wrapping
uint32 multiply-add over an iota), so there is no sequential dependency,
no drift, and time-sharded meshes get their phase offset analytically
(SURVEY.md section 5 "long-context" note) — shard s just adds
``s * shard_len * dtheta`` to the accumulator.  The carry is a single
uint32 per channel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_TWO_PI_OVER_2_32 = float(2.0 * np.pi / 4294967296.0)


def freq_to_dtheta(shift_hz: float, sample_rate: float) -> np.uint32:
    """Signed shift -> wrapping uint32 phase increment per sample."""
    turns = float(shift_hz) / float(sample_rate)  # cycles per sample
    step = int(round((turns - np.floor(turns)) * 4294967296.0)) & 0xFFFFFFFF
    return np.uint32(step)


def init(channels: int) -> jnp.ndarray:
    return jnp.zeros((channels,), jnp.uint32)


def _block_angles(n: int, phase_acc: jnp.ndarray, dtheta):
    dtheta = jnp.asarray(dtheta, jnp.uint32)
    idx = jnp.arange(n, dtype=jnp.uint32)
    # wrapping uint32 arithmetic == exact phase mod 2^32 turns
    phases = phase_acc[..., None] + idx * dtheta[..., None]
    ang = phases.astype(jnp.float32) * jnp.float32(_TWO_PI_OVER_2_32)
    new_acc = phase_acc + jnp.uint32(n) * dtheta
    return ang, new_acc


def apply_planar(xr: jnp.ndarray, xi: jnp.ndarray, phase_acc: jnp.ndarray,
                 dtheta):
    """Planar mix: (xr, xi) f32 planes (C, N) -> (yr, yi, new phase acc)."""
    ang, new_acc = _block_angles(xr.shape[-1], phase_acc, dtheta)
    c, s = jnp.cos(ang), jnp.sin(ang)
    return xr * c - xi * s, xr * s + xi * c, new_acc


def apply(x: jnp.ndarray, phase_acc: jnp.ndarray, dtheta) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Mix a block by the NCO.

    ``x``: (C, N) complex64; ``phase_acc``: (C,) uint32 carry;
    ``dtheta``: scalar or (C,) uint32 per-sample increment.
    Returns (mixed block, new phase accumulator).
    """
    yr, yi, new_acc = apply_planar(jnp.real(x), jnp.imag(x), phase_acc, dtheta)
    return jax.lax.complex(yr, yi).astype(jnp.complex64), new_acc


def reset(phase_acc: jnp.ndarray) -> jnp.ndarray:
    """Discontinuity reset: phase -> 0, frequency kept (frequency_shift.c:102)."""
    return jnp.zeros_like(phase_acc)
