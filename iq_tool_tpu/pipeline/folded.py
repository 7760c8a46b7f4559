"""Time-folded execution: one stream spread across batch rows.

Why: a batched chain fills the device with independent channels, but the
reference's PRIMARY use case is one stream (SURVEY.md section 3.2 hot
loop), which gives the step a batch of one.

Fold each channel's block into F consecutive time rows, so the compiled
step sees a (C*F, n_sub) batch — the same shape a C*F-channel chain runs
— and stitch the sequential state across rows INSIDE the step:

* halo tails (filters, resampler history, DC x_prev): row r uses row
  r-1's tail; row 0 uses the carry — a plain reshape+concat, the
  on-device analog of the sharded path's ppermute (parallel/sharded.py);
* DC IIR: zero-start recurrence per row + exact sequential prefix
  composition over F rows (first-order linear recurrence, identical math
  to the sharded cross-shard prefix);
* NCO: closed-form per-row phase offsets (uint32, exact);
* RMS AGC: per-segment energies from all rows concatenated in time order
  feed ONE gain scan — the gain trajectory is identical to sequential
  execution;
* digital AGC: one peak-lock update per folded step (peak over rows),
  the same per-global-block semantics as the sharded path;
* I/Q estimation: the estimator window is row 0's leading samples,
  computed exactly from the carry.

Equivalence contract (tests/test_folded.py): vs running the same stream
through the unfolded chain at the row block size, the only deltas
without the DC blocker are batched-matmul re-association — at most
+-1 code on <0.1% of samples, as batched C>1 channels show against C=1
runs — and with the DC blocker its f32 association differences may move
a few codes (60 dB SNR bound, code cap; identical to the sharded path's
contract).

The wire layout matches an unfolded chain at block F*n_sub, so
StreamEngine/CLI drive a FoldedChain unchanged; the carry pytree is the
row-block chain's carry (checkpoints interchangeable with it).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from iq_tool_tpu import constants as C
from iq_tool_tpu.ops import agc as agc_ops
from iq_tool_tpu.ops import convert, dc_block, iq_balance, nco
from iq_tool_tpu.pipeline.chain import Chain, ChainConfig


class FoldedChain:
    """Chain-compatible step over (C*F, n_sub) row batches.

    Exposes the same surface as Chain (step/init_carry/n_in/n_out/
    expected_out_frames/wire formats) at the global block size
    n_in = F * row_chain.n_in.
    """

    def __init__(self, cfg: ChainConfig, fold: int):
        if fold < 1:
            raise ValueError("fold must be >= 1")
        self.fold = int(fold)
        self.local = Chain(cfg)            # row-block geometry + plans
        self.cfg = cfg
        self.channels = cfg.channels
        self.rows = self.channels * self.fold
        if cfg.iq_correction and self.local.n_in < C.IQ_FFT_SIZE:
            raise ValueError("row block too small for I/Q estimation")

        self.n_in = self.local.n_in * self.fold
        self.n_out = self.local.n_out * self.fold
        self.in_wire_len = self.n_in * self.local.fmt_in.items_per_frame
        self.out_wire_len = self.n_out * self.local.fmt_out.items_per_frame
        self.in_wire_dtype = self.local.in_wire_dtype
        self.out_wire_dtype = self.local.out_wire_dtype
        self._jitted = None
        # Folding requires every stage's carried tail to fit in one row
        # (a tail wider than the row block is valid for the unfolded
        # chain, which handles n < hist).  A shape-only trace surfaces
        # any such mismatch NOW as a clean "incompatible" error.
        if fold > 1:
            try:
                carry_shape = jax.eval_shape(
                    lambda: self.local._build_carry(self.channels))
                jax.eval_shape(
                    self._step, carry_shape,
                    jax.ShapeDtypeStruct((self.channels, self.in_wire_len),
                                         self.in_wire_dtype),
                    jax.ShapeDtypeStruct((), np.bool_))
            except Exception as e:
                raise ValueError(
                    f"configuration incompatible with --time-fold {fold} "
                    f"(a stage's carried state exceeds the {self.local.n_in}"
                    f"-frame row block); use --time-fold 1: {e}") from None

    # Chain-compatible surface
    @property
    def fmt_in(self):
        return self.local.fmt_in

    @property
    def fmt_out(self):
        return self.local.fmt_out

    @property
    def resampler(self):
        return self.local.resampler

    def expected_out_frames(self, in_frames: int) -> int:
        return self.local.expected_out_frames(in_frames)

    def init_carry(self, channels: int | None = None) -> dict:
        return self.local.init_carry(channels)

    def _build_carry(self, channels: int) -> dict:
        """Traceable carry builder (bench scan bodies call this in-jit)."""
        return self.local._build_carry(channels)

    # --------------------------------------------------------------- helpers

    def _rows(self, x: jnp.ndarray) -> jnp.ndarray:
        """(C, F*W) -> (C*F, W): frames are contiguous, so rows are
        consecutive time slices of each channel."""
        return x.reshape(self.rows, x.shape[-1] // self.fold)

    def _unrows(self, x: jnp.ndarray) -> jnp.ndarray:
        return x.reshape(self.channels, x.shape[-1] * self.fold)

    def _rep(self, v: jnp.ndarray) -> jnp.ndarray:
        """Per-channel vector/matrix -> per-row (repeat along a new row
        axis): (C, ...) -> (C*F, ...)."""
        return jnp.repeat(v, self.fold, axis=0)

    def _shift_rows(self, tails: jnp.ndarray, carry_tail: jnp.ndarray):
        """tails: (R, H) per-row trailing values; carry_tail: (C, H) = the
        previous step's final row tails.  Returns (use (R, H), new (C, H))
        — the on-device halo."""
        cview = tails.reshape(self.channels, self.fold, -1)
        use = jnp.concatenate([carry_tail[:, None], cview[:, :-1]],
                              axis=1).reshape(self.rows, -1)
        return use, cview[:, -1]

    def _row_phases(self, carry_acc: jnp.ndarray, n_sub: int, dtheta):
        """Exact uint32 per-row NCO phase offsets (closed form)."""
        offs = (jnp.arange(self.fold, dtype=jnp.uint32)
                * jnp.uint32(n_sub & 0xFFFFFFFF) * jnp.uint32(dtheta))
        return (self._rep(carry_acc) + jnp.tile(offs, self.channels))

    def _compose_dc_starts(self, ends: jnp.ndarray, carry_y: jnp.ndarray,
                           a_l: jnp.ndarray):
        """Zero-start row ends (R,) + carry (C,) -> true per-row start
        values (R,) and the next-step carry (C,): sequential first-order
        composition over F rows (8 scalar-vector ops)."""
        e = ends.reshape(self.channels, self.fold)
        starts = [carry_y]
        for r in range(1, self.fold):
            starts.append(e[:, r - 1] + a_l * starts[r - 1])
        new_carry = e[:, -1] + a_l * starts[-1]
        return jnp.stack(starts, axis=1).reshape(self.rows), new_carry

    # ------------------------------------------------------------------ step

    def _dc_folded_plane(self, x, x_prev_use, carry_y, alpha):
        """Exact cross-row first-order IIR on one real plane (XLA path)."""
        n = x.shape[-1]
        y0, _, end0 = dc_block._apply_plane(
            x, x_prev_use, jnp.zeros((self.rows,), jnp.float32), alpha)
        a_real = 1.0 - alpha
        a_l = jnp.float32(a_real ** n)
        starts, new_carry = self._compose_dc_starts(end0, carry_y, a_l)
        apow = np.power(a_real, np.arange(1, n + 1),
                        dtype=np.float64).astype(np.float32)
        return y0 + starts[:, None] * apow[None, :], new_carry

    def _agc_folded_gains(self, xr, xi, state, cfg):
        """(gains (R, n_seg) or (R, 1), seg, new_state): the per-row gain
        schedule with the gain scan run over the global (cross-row) time
        order."""
        if cfg.profile == "digital":
            pk = jnp.sqrt(jnp.max((xr * xr + xi * xi)
                                  .reshape(self.channels, -1), axis=-1))
            gain, new_state = agc_ops.digital_update(
                state, pk, self.n_out, cfg)
            return self._rep(gain)[:, None], 0, new_state
        n = xr.shape[-1]
        n_seg, seg, beta = agc_ops.rms_params(cfg, n)
        xsr = xr[:, : n_seg * seg].reshape(self.rows, n_seg, seg)
        xsi = xi[:, : n_seg * seg].reshape(self.rows, n_seg, seg)
        e_rows = jnp.mean(xsr * xsr + xsi * xsi, axis=-1)       # (R, n_seg)
        # rows in time order per channel -> (F*n_seg, C) global sequence
        e_seq = (e_rows.reshape(self.channels, self.fold * n_seg)
                 .T)                                            # (F*n_seg, C)
        gains, g_fin, e2_fin = agc_ops.rms_scan(
            e_seq, state.gain, state.e2, beta, cfg.target)
        g_rows = gains.T.reshape(self.rows, n_seg)
        new_state = state._replace(
            gain=g_fin, e2=e2_fin,
            samples_seen=state.samples_seen + jnp.uint32(self.n_out))
        return g_rows, seg, new_state

    def _agc_folded(self, xr, xi, state, cfg):
        gains, seg, new_state = self._agc_folded_gains(xr, xi, state, cfg)
        if seg == 0:
            g = gains
            return xr * g, xi * g, new_state
        n = xr.shape[-1]
        n_seg = gains.shape[-1]
        g_rows = gains[:, :, None]
        xsr = xr[:, : n_seg * seg].reshape(self.rows, n_seg, seg)
        xsi = xi[:, : n_seg * seg].reshape(self.rows, n_seg, seg)
        yr = (xsr * g_rows).reshape(self.rows, n_seg * seg)
        yi = (xsi * g_rows).reshape(self.rows, n_seg * seg)
        if n_seg * seg < n:
            g_last = g_rows[:, -1]
            yr = jnp.concatenate([yr, xr[:, n_seg * seg:] * g_last], -1)
            yi = jnp.concatenate([yi, xi[:, n_seg * seg:] * g_last], -1)
        return yr, yi, new_state

    def _step(self, carry: dict, raw: jnp.ndarray, reset: jnp.ndarray):
        lc = self.local
        cfg = lc.cfg
        carry = jax.lax.cond(reset, lc._reset_carry, lambda c: c, carry)
        new = dict(carry)

        xr, xi = convert.to_planar(self._rows(raw), self.fmt_in, cfg.gain)
        n = lc.n_in
        if cfg.dc_block:
            xpr, cxr = self._shift_rows(xr[:, -1:],
                                        carry["dc"].xr_prev[:, None])
            xpi, cxi = self._shift_rows(xi[:, -1:],
                                        carry["dc"].xi_prev[:, None])
            xr, cyr = self._dc_folded_plane(xr, xpr[:, 0],
                                            carry["dc"].yr_prev, lc.dc_alpha)
            xi, cyi = self._dc_folded_plane(xi, xpi[:, 0],
                                            carry["dc"].yi_prev, lc.dc_alpha)
            new["dc"] = dc_block.PlanarDcState(cxr[:, 0], cxi[:, 0], cyr, cyi)
        if cfg.iq_correction:
            nf = C.IQ_FFT_SIZE
            seg_r = xr.reshape(self.channels, self.fold, n)[:, 0, :nf]
            seg_i = xi.reshape(self.channels, self.fold, n)[:, 0, :nf]
            new["iq"] = iq_balance.maybe_update_planar(
                seg_r, seg_i, carry["iq"], lc.iq_interval,
                advance_samples=self.n_in)
            xr, xi = iq_balance.apply_planar(xr, xi,
                                             self._rep(new["iq"].factors))
        if int(lc.dtheta_pre) != 0:
            phase = self._row_phases(carry["nco_pre"], n, lc.dtheta_pre)
            xr, xi, _ = nco.apply_planar(xr, xi, phase, lc.dtheta_pre)
            new["nco_pre"] = (carry["nco_pre"]
                              + jnp.uint32(self.n_in & 0xFFFFFFFF)
                              * lc.dtheta_pre)
        if lc.pre_filter:
            b = lc.pre_filter.block
            ur, cr = self._shift_rows(xr[:, -b:], carry["pre_f"][0])
            ui, ci = self._shift_rows(xi[:, -b:], carry["pre_f"][1])
            xr, xi, _, _ = lc.pre_filter.apply_planar(xr, xi, ur, ui)
            new["pre_f"] = (cr, ci)
        if lc.resampler:
            new_rs = []
            for stage, st in zip(lc.resampler.stages, carry["rs"]):
                h = st[0].shape[-1]
                ur, cr = self._shift_rows(xr[:, -h:], st[0])
                ui, ci = self._shift_rows(xi[:, -h:], st[1])
                xr, xi, _, _ = stage.apply_planar(xr, xi, ur, ui)
                new_rs.append((cr, ci))
            new["rs"] = tuple(new_rs)
        if lc.post_filter:
            b = lc.post_filter.block
            ur, cr = self._shift_rows(xr[:, -b:], carry["post_f"][0])
            ui, ci = self._shift_rows(xi[:, -b:], carry["post_f"][1])
            xr, xi, _, _ = lc.post_filter.apply_planar(xr, xi, ur, ui)
            new["post_f"] = (cr, ci)
        # digital AGC: peak measured pre-NCO, as Chain._step does
        dig_gain = None
        if lc.agc_cfg is not None and lc.agc_cfg.profile == "digital":
            dig_gain, _, new["agc"] = self._agc_folded_gains(
                xr, xi, carry["agc"], lc.agc_cfg)
        if int(lc.dtheta_post) != 0:
            phase = self._row_phases(carry["nco_post"], lc.n_out,
                                     lc.dtheta_post)
            xr, xi, _ = nco.apply_planar(xr, xi, phase, lc.dtheta_post)
            new["nco_post"] = (carry["nco_post"]
                               + jnp.uint32(self.n_out & 0xFFFFFFFF)
                               * lc.dtheta_post)
        if lc.agc_cfg:
            if dig_gain is not None:
                xr, xi = xr * dig_gain, xi * dig_gain
            else:
                xr, xi, new["agc"] = self._agc_folded(xr, xi, carry["agc"],
                                                      lc.agc_cfg)
        out = convert.from_planar(xr, xi, self.fmt_out)
        return new, self._unrows(out)

    @property
    def step(self):
        if self._jitted is None:
            self._jitted = jax.jit(self._step, donate_argnums=(0,))
        return self._jitted
