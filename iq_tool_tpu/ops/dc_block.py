"""First-order IIR DC blocker.

Contract (src/dc_block.c:20-86):  H(z) = (1 - z^-1) / (1 - (1-a) z^-1)
with a = 2*pi*DC_BLOCK_CUTOFF_HZ / Fs at the *input* rate; applied
in-place per block; reset on stream discontinuity.

Design: the recurrence y[n] = (1-a)*y[n-1] + (x[n] - x[n-1]) is a
first-order *linear* recurrence with a CONSTANT coefficient, so it has
the closed form y[n] = sum_{j<=n} (1-a)^(n-j) b[j].  Instead of a
log-depth elementwise scan over the whole block (log2(N) full passes
over device memory), it runs as a two-level scan:

  1. tiles of T samples compute their local prefix via ONE triangular
     matmul b_tile @ M^T with M[i,j] = (1-a)^(i-j) — one pass;
  2. a tiny associative scan over the nb = N/T per-tile totals
     propagates the cross-tile carry ((C, nb) elements, negligible);
  3. y = y_local + (1-a)^(i+1) * carry_prev broadcast fixes every tile.

Carry is (x_prev, y_prev) per channel.  Falls back to the flat
associative scan when N has no usable tile divisor.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from iq_tool_tpu.constants import DC_BLOCK_CUTOFF_HZ
from iq_tool_tpu.ops.precision import DOT


class DcState(NamedTuple):
    x_prev: jnp.ndarray  # (C,) complex64
    y_prev: jnp.ndarray  # (C,) complex64


def alpha_for_rate(sample_rate: float, cutoff_hz: float = DC_BLOCK_CUTOFF_HZ) -> float:
    return float(2.0 * np.pi * cutoff_hz / sample_rate)


def init(channels: int) -> DcState:
    # two distinct buffers (a shared one breaks jit argument donation)
    return DcState(jnp.zeros((channels,), jnp.complex64),
                   jnp.zeros((channels,), jnp.complex64))


def reset(state: DcState) -> DcState:
    return DcState(jnp.zeros_like(state.x_prev), jnp.zeros_like(state.y_prev))


import functools


@functools.lru_cache(maxsize=None)
def _tri_matrix(a: float, t: int) -> np.ndarray:
    """M[i, j] = a^(i-j) for j <= i else 0; y_local = b @ M^T."""
    i = np.arange(t)
    e = i[:, None] - i[None, :]
    return np.where(e >= 0, np.float64(a) ** np.maximum(e, 0), 0.0).astype(np.float32)


def _tile_size(n: int, cap: int = 256, floor: int = 32) -> int:
    for d in range(min(cap, n), floor - 1, -1):
        if n % d == 0:
            return d
    return 0


def _combine(lhs, rhs):
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, b2 + a2 * b1


def _apply_plane(x: jnp.ndarray, x_prev: jnp.ndarray, y_prev: jnp.ndarray,
                 alpha: float):
    """One real plane: x (C, N) f32, carries (C,) f32 -> (y, x_last, y_last)."""
    a = float(1.0 - alpha)
    xm1 = jnp.concatenate([x_prev[:, None], x[:, :-1]], axis=-1)
    b = x - xm1
    # fold the carried y[-1] into the first element: y[0] = a*y[-1] + b[0]
    b = b.at[:, 0].add(jnp.float32(a) * y_prev)

    c, n = x.shape
    t = _tile_size(n)
    if t == 0 or n <= t:
        coeffs = jnp.full_like(b, jnp.float32(a))
        _, y = jax.lax.associative_scan(_combine, (coeffs, b), axis=-1)
        return y, x[:, -1], y[:, -1]

    nb = n // t
    bt = b.reshape(c, nb, t)
    m = jnp.asarray(_tri_matrix(a, t))
    dn = (((2,), (1,)), ((), ()))                   # contract tile dim with M cols
    y_local = jax.lax.dot_general(bt, m, dn,
                                  precision=DOT,
                                  preferred_element_type=jnp.float32)
    # cross-tile carry: Y[b] = y_local[b, -1] + a^T * Y[b-1]
    ends = y_local[:, :, -1]                        # (C, nb)
    coeffs = jnp.full_like(ends, jnp.float32(a ** t))
    _, carry = jax.lax.associative_scan(_combine, (coeffs, ends), axis=-1)
    prev = jnp.concatenate([jnp.zeros((c, 1), jnp.float32),
                            carry[:, :-1]], axis=-1)  # carry entering each tile
    decay = jnp.asarray((np.float64(a) ** np.arange(1, t + 1))
                        .astype(np.float32))
    y = (y_local + prev[:, :, None] * decay[None, None, :]).reshape(c, n)
    return y, x[:, -1], y[:, -1]


class PlanarDcState(NamedTuple):
    xr_prev: jnp.ndarray  # (C,) f32
    xi_prev: jnp.ndarray
    yr_prev: jnp.ndarray
    yi_prev: jnp.ndarray


def init_planar(channels: int) -> PlanarDcState:
    z = lambda: jnp.zeros((channels,), jnp.float32)
    return PlanarDcState(z(), z(), z(), z())


def apply_planar(xr: jnp.ndarray, xi: jnp.ndarray, state: PlanarDcState,
                 alpha: float):
    """Planar f32 planes (C, N) -> (yr, yi, new_state), each plane by
    the two-level scan."""
    yr, xr_l, yr_l = _apply_plane(xr, state.xr_prev, state.yr_prev, alpha)
    yi, xi_l, yi_l = _apply_plane(xi, state.xi_prev, state.yi_prev, alpha)
    return yr, yi, PlanarDcState(xr_l, xi_l, yr_l, yi_l)


def apply(x: jnp.ndarray, state: DcState, alpha: float) -> tuple[jnp.ndarray, DcState]:
    """x: (C, N) complex64 -> (y, new_state)."""
    ps = PlanarDcState(jnp.real(state.x_prev), jnp.imag(state.x_prev),
                       jnp.real(state.y_prev), jnp.imag(state.y_prev))
    yr, yi, ns = apply_planar(jnp.real(x), jnp.imag(x), ps, alpha)
    y = jax.lax.complex(yr, yi).astype(jnp.complex64)
    return y, DcState(jax.lax.complex(ns.xr_prev, ns.xi_prev),
                      jax.lax.complex(ns.yr_prev, ns.yi_prev))
