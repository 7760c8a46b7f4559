"""Streaming FIR execution: direct convolution and FFT overlap-save.

Reference behavior (src/filter.c):
* FIR path: liquid firfilt executed in-place per block (filter.c:449-462);
* FFT path: fftfilt overlap-save with an explicit remainder carry
  (filter.c:491-526), block size = next pow2 >= taps-1, doubled if
  < 2*taps, FFT length = 2*block (filter.c:317-336);
* implementation auto-choice: complex (asymmetric) taps -> FFT, symmetric
  -> FIR (filter.c:301-312), overridable.

Design: both paths are stateless block maps plus a carried input tail
(the whole overlap discipline lives in the carry, so time-sharded meshes
can halo-exchange the tail, SURVEY.md section 5):

* direct: banded Toeplitz matmul over strided windows (ops/banded.py) —
  the same primitive as the polyphase resampler; complex taps cost 4
  real matmuls instead of 2;
* overlap-save: ALL chunks of a block are FFT'd in one batched
  ``jnp.fft`` call — windows are built by reshaping the tail-extended
  block into (n_chunks, 2*block) overlapped segments, so there is no
  sequential chunk loop at all.

The carried tail has length ``block`` (>= taps-1), one tail per channel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from iq_tool_tpu import constants as C
from iq_tool_tpu.ops import banded
from iq_tool_tpu.ops.fir_design import choose_fft_block


def tail_len(num_taps: int, method: str, user_fft_size: int | None = None) -> int:
    if method == "fir":
        return num_taps - 1
    return choose_fft_block(num_taps, user_fft_size)


def init(channels: int, num_taps: int, method: str,
         user_fft_size: int | None = None) -> jnp.ndarray:
    return jnp.zeros((channels, tail_len(num_taps, method, user_fft_size)),
                     jnp.complex64)


def reset(state: jnp.ndarray) -> jnp.ndarray:
    return jnp.zeros_like(state)


def _toeplitz(taps: np.ndarray, stride: int) -> np.ndarray:
    """Banded Toeplitz T[L, S] (L = S + K - 1) with column i = reversed
    taps at rows [i, i+K): (win @ T)[b, i] = sum_k h[k] ext[b*S + i + K-1 - k],
    i.e. causal convolution anchored after the K-1 tail history."""
    k = len(taps)
    t = np.zeros((stride + k - 1, stride), taps.dtype)
    rev = taps[::-1]
    for i in range(stride):
        t[i:i + k, i] = rev
    return t


def _fft_filter(windows: jnp.ndarray, h: np.ndarray) -> jnp.ndarray:
    """Circular convolution of each window with the frequency response h."""
    return jnp.fft.ifft(jnp.fft.fft(windows) * h).astype(jnp.complex64)


@functools.lru_cache(maxsize=None)
def _freq_taps(taps_key, nfft: int):
    # kept as NUMPY so jit embeds it as a literal constant
    taps = np.asarray(taps_key, np.complex64)
    return np.fft.fft(taps, nfft).astype(np.complex64)


class StreamingFilter:
    """A designed filter bound to a method and block geometry.

    Stateless object holding static data (taps / freq response); the
    per-stream state is the external tail array, making instances safe to
    close over inside jit.
    """

    def __init__(self, taps: np.ndarray, method: str = "auto",
                 user_fft_size: int | None = None):
        taps = np.asarray(taps, np.complex64)
        if method == "auto":
            # The reference picks FFT for complex taps because liquid's
            # time-domain firfilt_cccf is slow (filter.c:301-312); here both
            # tap kinds run as banded matmuls whose cost grows with the
            # band width, so the crossover vs overlap-save is simply the tap
            # count.
            method = "fir" if len(taps) <= 1024 else "fft"
        self.method = method
        self.taps = taps
        self.num_taps = len(taps)
        self.block = tail_len(self.num_taps, method, user_fft_size)
        self._toeplitz_cache: dict[int, tuple] = {}
        if method == "fft":
            self.nfft = 2 * self.block
            self._h = _freq_taps(tuple(taps.tolist()), self.nfft)
            # Overlap-save with nfft >= taps+block-1 IS exact linear
            # convolution, so for moderate tap counts the same output
            # comes off the banded matmul instead of an FFT round trip.
            # Keep the (C, block) carry and output semantics; only the
            # execution engine changes.
            self._exec_banded = self.num_taps <= 2048
        else:
            self._h = taps
            self._exec_banded = True

    def _toeplitz_for(self, stride: int) -> tuple[np.ndarray, np.ndarray | None]:
        if stride not in self._toeplitz_cache:
            tr = _toeplitz(np.real(self.taps).astype(np.float32), stride)
            ti = None
            if np.any(np.abs(self.taps.imag) > 0):
                ti = _toeplitz(np.imag(self.taps).astype(np.float32), stride)
            self._toeplitz_cache[stride] = (tr, ti)
        return self._toeplitz_cache[stride]

    def init(self, channels: int) -> jnp.ndarray:
        return jnp.zeros((channels, self.block), jnp.complex64)

    def init_planar(self, channels: int) -> tuple[jnp.ndarray, jnp.ndarray]:
        z = lambda: jnp.zeros((channels, self.block), jnp.float32)
        return z(), z()

    def apply_planar(self, xr: jnp.ndarray, xi: jnp.ndarray,
                     state_r: jnp.ndarray, state_i: jnp.ndarray):
        """Planar f32 path: (xr, xi) (C, N) -> (yr, yi, new_r, new_i)."""
        n = xr.shape[-1]
        if self._exec_banded:
            k = self.num_taps
            if k == 1:
                hr = float(np.real(self.taps[0]))
                hi = float(np.imag(self.taps[0]))
                return (xr * hr - xi * hi, xr * hi + xi * hr,
                        state_r, state_i)
            hist = self.block if self.method == "fft" else k - 1
            stride = banded.largest_divisor_leq(n, C.BANDED_STRIDE_CAP)
            tr, ti = self._toeplitz_for(stride)
            yr, yi = banded.apply_planar(state_r[:, hist - (k - 1):],
                                         state_i[:, hist - (k - 1):],
                                         xr, xi, tr, ti, stride, k - 1)
            return (yr, yi, banded.new_tail(state_r, xr, hist),
                    banded.new_tail(state_i, xi, hist))
        # overlap-save path works in the complex domain
        x = jax.lax.complex(xr, xi).astype(jnp.complex64)
        st = jax.lax.complex(state_r, state_i).astype(jnp.complex64)
        y, ns = self(x, st)
        return jnp.real(y), jnp.imag(y), jnp.real(ns), jnp.imag(ns)

    def __call__(self, x: jnp.ndarray, state: jnp.ndarray):
        """x: (C, N) complex64, state: (C, block) -> (y (C, N), new state).

        N must be a positive multiple of ``block`` for the fft method
        (the chain builder arranges this).
        """
        c, n = x.shape
        if self._exec_banded:
            yr, yi, nr, ni = self.apply_planar(
                jnp.real(x), jnp.imag(x), jnp.real(state), jnp.imag(state))
            return (jax.lax.complex(yr, yi).astype(jnp.complex64),
                    jax.lax.complex(nr, ni).astype(jnp.complex64))

        b = self.block
        if n < b:
            raise ValueError(f"block length {n} smaller than filter block {b}")
        ext = jnp.concatenate([state, x], axis=-1)       # (C, n + b)
        if n % b == 0:
            segs = ext.reshape(c, n // b + 1, b)
            windows = jnp.concatenate([segs[:, :-1], segs[:, 1:]], axis=-1)
            out = _fft_filter(windows, self._h)[..., b:]
            y = out.reshape(c, n)
        else:
            # Arbitrary n: static overlapping windows. Chunk i produces
            # outputs [s_i, s_i + b); the last window is re-anchored at
            # n - b so every output is covered with fixed shapes (its
            # leading duplicate outputs are discarded).
            nc = -(-n // b)
            starts = np.arange(nc, dtype=np.int64) * b
            starts[-1] = n - b
            idx = starts[:, None] + np.arange(2 * b, dtype=np.int64)[None, :]
            windows = jnp.take(ext, jnp.asarray(idx), axis=-1)  # (C, nc, 2b)
            out = _fft_filter(windows, self._h)[..., b:]
            head = out[:, :-1, :].reshape(c, (nc - 1) * b)
            tail = out[:, -1, -(n - (nc - 1) * b):]
            y = jnp.concatenate([head, tail], axis=-1)
        return y.astype(jnp.complex64), ext[:, -b:]
