"""Strided-window banded matmul: the shared execution primitive.

Both polyphase resampling (ops/resample.py) and direct FIR filtering
(ops/filters.py) are "banded" linear maps: every output sample depends on
K consecutive inputs, with output m anchored at input s_m (s_m = m for a
FIR, floor(m*q/p) for a p/q polyphase).  The reference delegates these to
liquid-dsp's sequential per-sample loops (firfilt_crcf_execute_block,
msresamp_crcf_execute); a literal translation (gather + einsum) builds a
(C, M, K) intermediate tensor.

Instead the band is densified over a GROUP of G outputs into a constant
matrix A[L, G] (A[s_m + k, m] = w[m, k]), windows of length L at stride S
are built from reshaped slices of the tail-extended input (no gather),
and the whole group computes as ONE matmul ``win @ A`` at
``precision.DOT``.

On the GPU, maps with long windows run instead as one Pallas kernel
(ops/banded_kernel.py) that gathers its windows on chip and skips A's
zero rows (``use_kernel``); the XLA path above serves every other map,
every other platform, and is the kernel's reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from iq_tool_tpu.ops.precision import DOT


def build_windows(ext: jnp.ndarray, stride: int, hist: int) -> jnp.ndarray:
    """Overlapping windows win[b] = ext[b*S : b*S + S + hist] without a
    gather: each view j contributes columns [j*S, (j+1)*S) of the window
    from a plain reshape of ext shifted by j*S (views are zero-padded past
    the end; the pad lands beyond the window length and is dropped).

    ext: (C, hist + n) with n a multiple of stride -> (C, n // S, S + hist).
    """
    ch = ext.shape[0]
    n = ext.shape[-1] - hist
    nb = n // stride
    s = stride
    parts = []
    remaining = s + hist
    j = 0
    while remaining > 0:
        src = ext[:, j * s:j * s + nb * s]
        pad = nb * s - src.shape[-1]
        if pad > 0:
            src = jnp.pad(src, ((0, 0), (0, pad)))
        take = min(s, remaining)
        parts.append(src.reshape(ch, nb, s)[:, :, :take])
        remaining -= take
        j += 1
    return jnp.concatenate(parts, axis=-1)


def window_matmul_planar(win_r: jnp.ndarray, win_i: jnp.ndarray,
                         a_r: np.ndarray, a_i: np.ndarray | None = None):
    """Planar (C, nb, L) f32 windows @ (L, G) banded matrix -> two
    (C, nb*G) f32 planes.  Real A needs 2 real matmuls; complex A needs 4.
    """
    ch, nb, _ = win_r.shape
    g = a_r.shape[1]
    dn = (((2,), (0,)), ((), ()))
    ar = jnp.asarray(a_r)

    def dot(lhs, rhs):
        return jax.lax.dot_general(lhs, rhs, dn, precision=DOT,
                                   preferred_element_type=jnp.float32)

    yr = dot(win_r, ar)
    yi = dot(win_i, ar)
    if a_i is not None and np.any(a_i):
        ai = jnp.asarray(a_i)
        yr = yr - dot(win_i, ai)
        yi = yi + dot(win_r, ai)
    return yr.reshape(ch, nb * g), yi.reshape(ch, nb * g)


def largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (>= 1)."""
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def new_tail(state: jnp.ndarray, x: jnp.ndarray, hist: int) -> jnp.ndarray:
    """The carry for the next block: last `hist` samples of state ++ x."""
    if x.shape[-1] >= hist:
        return x[:, x.shape[-1] - hist:]
    return jnp.concatenate([state, x], axis=-1)[:, -hist:]


# Where the kernel beats the XLA windows + matmul on an H100, at 128
# channels: windows of 543 samples with 512 or 882 windows per row
# (stride 512 / hist 31: 2.01 vs 2.34 ms; stride 256 / hist 287: a tie,
# 2.28 vs 2.21 ms); not with windows of 287 or 330 samples (1.86 vs
# 1.29 ms, 2.15 vs 1.49 ms), nor with 32 windows per row (0.45 vs
# 0.35 ms), where most of a program's window tile is empty.
KERNEL_MIN_WINDOW = 512
KERNEL_MIN_WINDOWS = 512


def use_kernel(stride: int, hist: int, n_windows: int) -> bool:
    """Static choice, made before tracing: does a map with windows of
    stride + hist samples, n_windows of them per row, pay for the kernel
    on the GPU?"""
    return (hist > 0 and stride + hist >= KERNEL_MIN_WINDOW
            and n_windows >= KERNEL_MIN_WINDOWS)


def apply_planar(state_r: jnp.ndarray, state_i: jnp.ndarray,
                 xr: jnp.ndarray, xi: jnp.ndarray,
                 a_r: np.ndarray, a_i: np.ndarray | None,
                 stride: int, hist: int):
    """Banded map over a block with carried tap history.

    state_*: (C, hist); x*: (C, n); returns (yr, yi): (C, (n//stride)*G).
    """
    if use_kernel(stride, hist, xr.shape[-1] // stride):
        from iq_tool_tpu.ops import banded_kernel
        return jax.lax.platform_dependent(
            state_r, state_i, xr, xi,
            cuda=lambda *v: banded_kernel.apply(*v, a_r, a_i, stride, hist),
            default=lambda *v: _apply_xla(*v, a_r, a_i, stride, hist))
    return _apply_xla(state_r, state_i, xr, xi, a_r, a_i, stride, hist)


def _apply_xla(state_r, state_i, xr, xi, a_r, a_i, stride, hist):
    ext_r = jnp.concatenate([state_r, xr], axis=-1)
    ext_i = jnp.concatenate([state_i, xi], axis=-1)
    win_r = build_windows(ext_r, stride, hist)
    win_i = build_windows(ext_i, stride, hist)
    return window_matmul_planar(win_r, win_i, a_r, a_i)
