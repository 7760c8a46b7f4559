"""Arbitrary-ratio multi-stage polyphase resampler (msresamp_crcf role).

Contract (src/resampler.c, setup.c:91-122): ratio = target_rate /
input_rate, validated 0.001..1000; 60 dB stop-band attenuation
(constants.h:137); streaming `execute`; reset on discontinuity.

Architecture (re-designed from liquid msresamp's staging):

* Ratios are rationalized to P/Q (Farey-bounded; exact for real-world
  integer rate pairs), then P/Q is decomposed into a cascade of small
  coprime rational stages p_i/q_i (prime-factor pairing, each factor
  bounded so the stage's dense weight matrix stays small).  The
  device block is a multiple of prod(q_i), so every stage sees a static
  shape and produces EXACTLY n*p/q outputs per block — no data-dependent
  shapes, no fractional carry.

* Every stage is an *analytic* polyphase executed as ONE banded
  matmul (ops/banded.py): the finite set of fractional phases is evaluated exactly into
  per-phase Kaiser-sinc weights (zero phase-quantization error — liquid
  quantizes to a 64-entry filterbank and lerps), which are densified
  into a banded matrix A[L, G] with A[s_m + k, m] = W[m, k].  Input
  windows of length L at stride g*q are built by two reshaped slices
  (overlap = K-1 tap history), and out = windows @ A.  This trades pad
  flops (the band is ~K wide inside L) for eliminating the gather that
  would otherwise materialize a (C, M, K) tensor.

* A single-stage gather path (`_ArbStage`) remains as the fallback for
  ratios whose rationalization has a prime factor too large to stage.

Per-stream carry: a tuple of per-stage input tails (the K-1 most recent
input samples of that stage), which is also what the time-sharded mesh
exchanges as halos (parallel/sharded.py).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from iq_tool_tpu import constants as C
from iq_tool_tpu.ops import banded
from iq_tool_tpu.ops.fir_design import kaiser_beta as _kaiser_beta
from iq_tool_tpu.ops.precision import DOT


def rationalize(ratio: float, max_denom: int = C.RESAMP_MAX_DENOM) -> tuple[int, int]:
    """ratio -> (P, Q) in lowest terms, |ratio - P/Q| minimal for Q <= max."""
    if not (C.RESAMPLE_RATIO_MIN <= ratio <= C.RESAMPLE_RATIO_MAX):
        raise ValueError(
            f"resample ratio {ratio} out of range "
            f"[{C.RESAMPLE_RATIO_MIN}, {C.RESAMPLE_RATIO_MAX}] (setup.c:106-113)")
    fr = Fraction(ratio).limit_denominator(max_denom)
    return fr.numerator, fr.denominator


def _kernel(t: np.ndarray, fc: float, semilen: int, beta: float) -> np.ndarray:
    """Kaiser-windowed sinc at arbitrary real offsets t (input-sample units)."""
    w_arg = 1.0 - (t / semilen) ** 2
    w = np.where(w_arg > 0, np.i0(beta * np.sqrt(np.maximum(w_arg, 0.0))), 0.0)
    w = w / np.i0(beta)
    g = 2.0 * fc * np.sinc(2.0 * fc * t)
    return np.where(np.abs(t) <= semilen, g * w, 0.0)


# ------------------------------ staging ---------------------------------------

def _prime_factors(n: int) -> list[int]:
    """Prime factors with multiplicity, descending."""
    out, d = [], 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return sorted(out, reverse=True)


def decompose_stages(p: int, q: int,
                     max_factor: int = C.RESAMP_STAGE_MAX) -> list[tuple[int, int]] | None:
    """Split P/Q (coprime) into stage ratios (p_i, q_i), each <= max_factor,
    whose product is exactly P/Q, or None if a prime factor is too large.

    Greedy pairing: each stage takes as much numerator as fits, then as
    much denominator as fits while the stage ratio stays >= ~1/2 (so each
    stage's anti-alias kernel keeps the standard length); leftover
    denominator primes become deep-decimation stages with scaled kernels.
    Stages are sorted by descending ratio so intermediate rates never dip
    below the final rate (no information loss mid-cascade).
    """
    pf, qf = _prime_factors(p), _prime_factors(q)
    if (pf and pf[0] > max_factor) or (qf and qf[0] > max_factor):
        return None
    stages: list[tuple[int, int]] = []
    while pf or qf:
        pi = 1
        while pf and pi * pf[0] <= max_factor:
            pi *= pf.pop(0)
        qi = 1
        while qf and qi * qf[0] <= max_factor and pi / (qi * qf[0]) >= 0.45:
            qi *= qf.pop(0)
        if pi == 1 and qi == 1 and qf:
            qi = qf.pop(0)                      # forced deep-decim stage
        if pi == 1 and qi == 1:
            break
        stages.append((pi, qi))
    stages.sort(key=lambda s: s[0] / s[1], reverse=True)
    return stages


# ------------------------------ stages ---------------------------------------

class _MatmulStage:
    """Rational p/q polyphase stage executed as one banded matmul.

    Windows of length L = g*q + K - 1 at stride g*q are built from two
    reshaped slices of the (state ++ x) extension; out = win @ A where
    A[L, g*p] densifies the exact per-phase Kaiser-sinc weights.  The
    kernel semilength scales with q/p for deep-decimation stages so the
    anti-alias transition band keeps the design attenuation.
    """

    def __init__(self, p: int, q: int, n_in: int, atten_db: float,
                 semilength: int, group_cap: int = C.RESAMP_GROUP_CAP):
        assert n_in % q == 0
        g = banded.largest_divisor_leq(n_in // q,
                                       max(1, group_cap // max(p, q)))
        m = max(semilength, int(np.ceil(semilength * q / (2.0 * p))))
        plan = _make_arb_plan(p, q, g * q, atten_db, m)
        k_taps = plan.weights.shape[1]
        L = g * q + plan.history
        G = g * p
        a = np.zeros((L, G), np.float32)
        for i in range(G):
            a[plan.starts[i]:plan.starts[i] + k_taps, i] = plan.weights[i]
        self.p, self.q, self.g = p, q, g
        self.stride = g * q
        self.hist = plan.history
        self.n_out_per_group = G
        self._a = a
        self._a_i = None          # imaginary part when an FIR was composed

    # --------------------- design-time operator fusion -----------------------
    # An FIR before/after the stage is also LTI, so it folds into the banded
    # matrix at DESIGN time: one fewer device pass, one fewer halo exchange
    # on the time-sharded mesh, zero runtime cost.

    def compose_input_fir(self, taps: np.ndarray) -> None:
        """Absorb y = stage(fir(x)): convolve A's rows with the taps
        (input-side convolution extends the window left by K-1)."""
        k = len(taps)
        l_old, g = self._a.shape
        a_old = (self._a.astype(np.complex128)
                 + (1j * self._a_i if self._a_i is not None else 0))
        a_new = np.zeros((l_old + k - 1, g), np.complex128)
        for j in range(k):
            a_new[k - 1 - j:k - 1 - j + l_old, :] += taps[j] * a_old
        self.hist += k - 1
        self._a = np.ascontiguousarray(a_new.real.astype(np.float32))
        self._a_i = (np.ascontiguousarray(a_new.imag.astype(np.float32))
                     if np.abs(a_new.imag).max() > 0 else None)

    def compose_output_fir(self, taps: np.ndarray) -> None:
        """Absorb z = fir(stage(x)): z[bG+i] = sum_j h[j] y[bG+i-j], which
        reaches ceil((K-1)/G) groups back — extend the window left by that
        many strides and accumulate shifted copies of A's columns."""
        k = len(taps)
        l_old, gg = self._a.shape
        s = self.stride
        kb = -(-(k - 1) // gg)
        ext = kb * s
        a_old = (self._a.astype(np.complex128)
                 + (1j * self._a_i if self._a_i is not None else 0))
        a_c = np.zeros((l_old + ext, gg), np.complex128)
        for j in range(k):
            for i in range(gg):
                d, r = divmod(i - j, gg)       # d <= 0: groups back
                # coeff row t maps x[bS + t - hist_c]; source row
                # t' = t - ext + (-d)*S must be in [0, l_old)
                off = ext + d * s
                a_c[off:off + l_old, i] += taps[j] * a_old[:, r]
        self.hist += ext
        self._a = np.ascontiguousarray(a_c.real.astype(np.float32))
        self._a_i = (np.ascontiguousarray(a_c.imag.astype(np.float32))
                     if np.abs(a_c.imag).max() > 0 else None)

    def init(self, channels: int) -> jnp.ndarray:
        return jnp.zeros((channels, self.hist), jnp.complex64)

    def init_planar(self, channels: int) -> tuple[jnp.ndarray, jnp.ndarray]:
        z = lambda: jnp.zeros((channels, self.hist), jnp.float32)
        return z(), z()

    def out_len(self, n: int) -> int:
        """Static output length for an n-sample input block."""
        return (n // self.stride) * self._a.shape[1]

    def apply_planar(self, xr, xi, state_r, state_i):
        yr, yi = banded.apply_planar(state_r, state_i, xr, xi, self._a,
                                     self._a_i, self.stride, self.hist)
        return (yr, yi, banded.new_tail(state_r, xr, self.hist),
                banded.new_tail(state_i, xi, self.hist))

    def __call__(self, x, state):
        yr, yi, nr, ni = self.apply_planar(
            jnp.real(x), jnp.imag(x), jnp.real(state), jnp.imag(state))
        return (jax.lax.complex(yr, yi).astype(jnp.complex64),
                jax.lax.complex(nr, ni).astype(jnp.complex64))


@dataclasses.dataclass(frozen=True)
class ArbPlan:
    p: int
    q: int
    n_in: int
    n_out: int
    semilength: int
    history: int
    weights: np.ndarray
    starts: np.ndarray


def _make_arb_plan(p: int, q: int, n_in: int, atten_db: float,
                   semilength: int) -> ArbPlan:
    assert n_in % q == 0
    n_out = n_in * p // q
    m = int(semilength)
    k_taps = 2 * m
    hist = 2 * m - 1
    beta = _kaiser_beta(atten_db)
    fc = 0.5 * min(1.0, p / q) * C.RESAMP_FC_FACTOR

    mm = np.arange(n_out, dtype=np.float64)
    tau = mm * q / p - m               # delayed interpolation time
    n_base = np.floor(tau).astype(np.int64)
    frac = tau - n_base
    k = np.arange(k_taps, dtype=np.float64)
    t = frac[:, None] + (m - 1) - k[None, :]
    w = _kernel(t, fc, m, beta)
    w = w / np.sum(w, axis=1, keepdims=True)   # exact unity DC per phase
    starts = (n_base - m + 1 + hist).astype(np.int64)
    assert starts.min() >= 0 and starts.max() + k_taps <= n_in + hist, \
        (starts.min(), starts.max(), n_in, hist)
    return ArbPlan(p=p, q=q, n_in=n_in, n_out=n_out, semilength=m,
                   history=hist, weights=w.astype(np.float32),
                   starts=starts.astype(np.int32))


class _ArbStage:
    def __init__(self, plan: ArbPlan):
        self.plan = plan
        k_taps = plan.weights.shape[1]
        # numpy (not device arrays): jit embeds them as literal constants
        self._idx = plan.starts[:, None] + np.arange(k_taps, dtype=np.int32)[None, :]
        self._wr = plan.weights

    def init(self, channels: int) -> jnp.ndarray:
        return jnp.zeros((channels, self.plan.history), jnp.complex64)

    def init_planar(self, channels: int) -> tuple[jnp.ndarray, jnp.ndarray]:
        z = lambda: jnp.zeros((channels, self.plan.history), jnp.float32)
        return z(), z()

    def _plane(self, x, state):
        ext = jnp.concatenate([state, x], axis=-1)
        windows = ext[:, self._idx]                        # (C, M, K)
        w = jnp.asarray(self._wr)
        y = jnp.einsum("cmk,mk->cm", windows, w,
                       precision=DOT)
        return y, ext[:, -self.plan.history:]

    def apply_planar(self, xr, xi, state_r, state_i):
        yr, nr = self._plane(xr, state_r)
        yi, ni = self._plane(xi, state_i)
        return yr, yi, nr, ni

    def __call__(self, x, state):
        yr, yi, nr, ni = self.apply_planar(
            jnp.real(x), jnp.imag(x), jnp.real(state), jnp.imag(state))
        return (jax.lax.complex(yr, yi).astype(jnp.complex64),
                jax.lax.complex(nr, ni).astype(jnp.complex64))


# --------------------------- multi-stage driver ------------------------------

@dataclasses.dataclass(frozen=True)
class ResamplePlan:
    p: int
    q: int
    n_in: int
    n_out: int
    stages: tuple[tuple[int, int], ...]   # per-stage (p_i, q_i); () = passthrough
    fallback: bool = False                # True -> single gather-based arb stage

    @property
    def ratio(self) -> float:
        return self.p / self.q


class Resampler:
    """Multi-stage streaming resampler.

    Block contract: input blocks of exactly ``plan.n_in`` frames produce
    exactly ``plan.n_out`` frames.  Carry is a tuple of per-stage tails.
    """

    def __init__(self, ratio: float, target_block: int = C.DEFAULT_BLOCK_SIZE,
                 atten_db: float = C.RESAMPLER_ATTENUATION_DB,
                 semilength: int = C.RESAMP_SEMILENGTH,
                 max_denom: int = C.RESAMP_MAX_DENOM,
                 max_out: int = 1 << 21):
        p, q = rationalize(ratio, max_denom)
        ratios = decompose_stages(p, q)

        unit = q
        blocks = max(1, round(target_block / unit))
        n_in = blocks * unit
        n_out = n_in * p // q
        while n_out > max_out and blocks > 1:
            blocks -= 1
            n_in = blocks * unit
            n_out = n_in * p // q
        if n_out > max_out:
            raise ValueError(
                f"ratio {p}/{q}: block would need {n_out} outputs (> {max_out})")

        self.stages: list = []
        fallback = ratios is None
        if fallback and p != q:
            # rationalization hit a large prime: single exact gather stage.
            # Deep decimation needs the same semilength scaling _MatmulStage
            # applies, else the anti-alias transition band is far too wide
            # (measured ~11 dB alias rejection vs the 60 dB contract for
            # e.g. 2469/200000 with the unscaled semilength).
            m = max(semilength, int(np.ceil(semilength * q / (2.0 * p))))
            self.stages.append(
                _ArbStage(_make_arb_plan(p, q, n_in, atten_db, m)))
            ratios = [(p, q)]
        elif p != q:
            n_s = n_in
            for pi, qi in ratios:
                self.stages.append(
                    _MatmulStage(pi, qi, n_s, atten_db, semilength))
                n_s = n_s * pi // qi
            assert n_s == n_out, (n_s, n_out)
        else:
            ratios = []

        self.plan = ResamplePlan(p=p, q=q, n_in=n_in, n_out=n_out,
                                 stages=tuple(ratios or ()),
                                 fallback=fallback and p != q)

    def init(self, channels: int) -> tuple:
        return tuple(s.init(channels) for s in self.stages)

    def init_planar(self, channels: int) -> tuple:
        return tuple(s.init_planar(channels) for s in self.stages)

    def apply_planar(self, xr, xi, state: tuple):
        new_states = []
        for stage, (sr, si) in zip(self.stages, state):
            xr, xi, nr, ni = stage.apply_planar(xr, xi, sr, si)
            new_states.append((nr, ni))
        return xr, xi, tuple(new_states)

    def reset(self, state: tuple) -> tuple:
        return jax.tree_util.tree_map(jnp.zeros_like, state)

    def __call__(self, x: jnp.ndarray, state: tuple):
        new_states = []
        for stage, st in zip(self.stages, state):
            x, ns = stage(x, st)
            new_states.append(ns)
        return x, tuple(new_states)
