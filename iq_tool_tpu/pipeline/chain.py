"""The compiled DSP chain: one jitted step for the whole signal path.

Reference mapping (pre_processor.c:10-55, pipeline.c:492-537,
post_processor.c:9-70):

    convert -> dc_block -> iq_correct -> pre-NCO -> pre-filter
            -> resample -> post-filter -> post-NCO -> AGC -> convert

The reference runs these as 3 threads passing 16384-frame chunks through
queues; here the whole chain is ONE XLA program over a fixed-shape
``(channels, block)`` array, so every elementwise stage fuses and the
"queues" disappear into the compiler's dataflow.  All sequential stream
state lives in an explicit carry pytree (SampleChunk ping-pong buffers ->
SSA values; liquid object state -> carry leaves).

Stream discontinuities (pipeline.c:458-464/503-509/565-571) are a scalar
``reset`` flag input: when set, stateful stages are re-initialized inside
the same compiled step (I/Q factors are kept, matching iq_correct's
persistent learned state; NCO keeps frequency, zeroes phase).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from iq_tool_tpu import constants as C
from iq_tool_tpu.formats import get_format
from iq_tool_tpu.ops import agc as agc_ops
from iq_tool_tpu.ops import convert, dc_block, iq_balance, nco
from iq_tool_tpu.ops.filters import StreamingFilter
from iq_tool_tpu.ops.fir_design import FilterRequest, design_chain, max_filter_freq_hz
from iq_tool_tpu.ops.resample import Resampler, _MatmulStage


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """User intent for one stream (the AppConfig analog, app_context.h:66-138)."""
    input_format: str
    output_format: str
    input_rate: float
    target_rate: float | None = None          # None -> no resample
    channels: int = 1
    gain: float = 1.0
    dc_block: bool = False
    iq_correction: bool = False
    freq_shift_pre_hz: float = 0.0
    freq_shift_post_hz: float = 0.0
    filters: Sequence[FilterRequest] = ()
    filter_stage: str = "auto"                # auto | pre | post (filter.c:43-92)
    filter_method: str = "auto"               # auto | fir | fft
    filter_fft_size: int | None = None
    filter_taps: int | None = None
    filter_transition_hz: float | None = None
    filter_attenuation_db: float = C.RESAMPLER_ATTENUATION_DB
    agc_profile: str | None = None            # dx | local | digital
    agc_target: float | None = None
    target_block: int = C.DEFAULT_BLOCK_SIZE
    resampler_semilength: int = C.RESAMP_SEMILENGTH
    fuse_filters: bool = True              # fold direct FIRs into resampler stages

    @property
    def resampling(self) -> bool:
        return (self.target_rate is not None
                and abs(self.target_rate - self.input_rate) > 1e-9)

    @property
    def output_rate(self) -> float:
        return self.target_rate if self.resampling else self.input_rate


def _decide_filter_stage(cfg: ChainConfig) -> str:
    """filter.c:43-92: post-resample iff downsampling and the chain fits
    under the output Nyquist; error if it doesn't fit under input Nyquist."""
    if not cfg.filters:
        return "none"
    if cfg.filter_stage in ("pre", "post"):
        return cfg.filter_stage
    if not cfg.resampling:
        return "pre"
    in_rate, out_rate = cfg.input_rate, cfg.target_rate
    mx = max_filter_freq_hz(list(cfg.filters))
    if mx > in_rate / 2.0:
        raise ValueError(
            f"filter chain extends to {mx:.0f} Hz, above the input Nyquist "
            f"{in_rate / 2:.0f} Hz")
    if out_rate < in_rate:
        if mx > out_rate / 2.0:
            raise ValueError(
                f"filter chain extends to {mx:.0f} Hz, but the output rate "
                f"{out_rate:.0f} Hz supports only {out_rate / 2:.0f} Hz "
                "(filter.c:80-86)")
        return "post"
    return "pre"


class Chain:
    """Built, executable chain.  Immutable after construction; the jitted
    step closes over static plans only."""

    def __init__(self, cfg: ChainConfig):
        self.cfg = cfg
        self.fmt_in = get_format(cfg.input_format)
        self.fmt_out = get_format(cfg.output_format)

        stage = _decide_filter_stage(cfg)
        design_rate = cfg.output_rate if stage == "post" else cfg.input_rate
        designed = design_chain(list(cfg.filters), design_rate,
                                cfg.filter_attenuation_db, cfg.filter_taps,
                                cfg.filter_transition_hz) if cfg.filters else None
        self.filter_stage = stage
        self.designed_filter = designed

        filt = None
        if designed is not None:
            filt = StreamingFilter(designed.taps, cfg.filter_method,
                                   cfg.filter_fft_size)
        self.pre_filter = filt if stage == "pre" else None
        self.post_filter = filt if stage == "post" else None

        # --- block geometry: resampler framing + filter block constraints ---
        # (an FFT filter needs at least one overlap-save block per step)
        tb = cfg.target_block
        for _ in range(10):
            rs = (Resampler(cfg.target_rate / cfg.input_rate, tb,
                            cfg.filter_attenuation_db, cfg.resampler_semilength)
                  if cfg.resampling else None)
            n_in = rs.plan.n_in if rs else tb
            n_out = rs.plan.n_out if rs else tb
            if all(n >= filt.block
                   for filt, n in ((self.pre_filter, n_in),
                                   (self.post_filter, n_out))
                   if filt is not None and filt.method == "fft"):
                break
            tb *= 2
        else:
            raise ValueError("could not find a block size fitting the filter")
        self.resampler = rs
        self.n_in = n_in
        self.n_out = n_out

        # Design-time operator fusion: a direct-FIR user filter adjacent
        # to a matmul resampler stage is LTI, so it folds into that
        # stage's banded matrix — one fewer device pass and one fewer
        # halo exchange per step, at identical (composed) numerics.
        if (cfg.fuse_filters and rs is not None and rs.stages
                and isinstance(rs.stages[0], _MatmulStage)
                and self.pre_filter is not None
                and self.pre_filter.method == "fir"
                and self.pre_filter.num_taps <= C.FUSE_MAX_TAPS):
            rs.stages[0].compose_input_fir(
                np.asarray(self.pre_filter.taps, np.complex128))
            self.pre_filter = None
        if (cfg.fuse_filters and rs is not None and rs.stages
                and isinstance(rs.stages[-1], _MatmulStage)
                and self.post_filter is not None
                and self.post_filter.method == "fir"
                and self.post_filter.num_taps <= C.FUSE_MAX_TAPS):
            rs.stages[-1].compose_output_fir(
                np.asarray(self.post_filter.taps, np.complex128))
            self.post_filter = None

        self.dc_alpha = dc_block.alpha_for_rate(cfg.input_rate)
        self.dtheta_pre = nco.freq_to_dtheta(cfg.freq_shift_pre_hz, cfg.input_rate)
        self.dtheta_post = nco.freq_to_dtheta(cfg.freq_shift_post_hz,
                                              cfg.output_rate)
        for shift, rate, name in ((cfg.freq_shift_pre_hz, cfg.input_rate, "pre"),
                                  (cfg.freq_shift_post_hz, cfg.output_rate, "post")):
            if abs(shift) > C.FREQ_SHIFT_SANITY_FACTOR * rate:
                raise ValueError(
                    f"{name} frequency shift {shift:.0f} Hz exceeds "
                    f"{C.FREQ_SHIFT_SANITY_FACTOR}x the rate (constants.h:247)")

        self.agc_cfg = (agc_ops.AgcConfig.make(cfg.agc_profile, cfg.output_rate,
                                               cfg.agc_target)
                        if cfg.agc_profile else None)
        self.iq_interval = int(C.IQ_UPDATE_INTERVAL_SEC * cfg.input_rate)

        self.in_wire_len = self.n_in * self.fmt_in.items_per_frame
        self.out_wire_len = self.n_out * self.fmt_out.items_per_frame
        self.in_wire_dtype = convert.wire_dtype(self.fmt_in)
        self.out_wire_dtype = convert.wire_dtype(self.fmt_out)

        self._jitted = None

    # ------------------------------ carry ------------------------------------

    def init_carry(self, channels: int | None = None) -> dict:
        """The zero carry for ``channels`` streams (default: the config's)."""
        return self._build_carry(channels or self.cfg.channels)

    def _build_carry(self, ch: int) -> dict:
        """Carry leaves are PLANAR float32 (real/imag pairs): the whole
        step works on plane arrays — complex64 decomposes to plane math
        under XLA anyway, planar skips the re/im extraction round trips,
        and the Pallas banded kernel has no complex dtype."""
        carry = {"nco_pre": nco.init(ch), "nco_post": nco.init(ch)}
        if self.cfg.dc_block:
            carry["dc"] = dc_block.init_planar(ch)
        if self.cfg.iq_correction:
            carry["iq"] = iq_balance.init(ch)
        if self.pre_filter:
            carry["pre_f"] = self.pre_filter.init_planar(ch)
        if self.resampler:
            carry["rs"] = self.resampler.init_planar(ch)
        if self.post_filter:
            carry["post_f"] = self.post_filter.init_planar(ch)
        if self.agc_cfg:
            carry["agc"] = agc_ops.init(ch)
        return carry

    def _reset_carry(self, carry: dict) -> dict:
        """Discontinuity semantics: reset sample memory, keep learned state."""
        out = dict(carry)
        out["nco_pre"] = nco.reset(carry["nco_pre"])
        out["nco_post"] = nco.reset(carry["nco_post"])
        for key in ("dc", "pre_f", "rs", "post_f"):
            if key in carry:
                out[key] = jax.tree_util.tree_map(jnp.zeros_like, carry[key])
        if "agc" in carry:
            out["agc"] = agc_ops.reset(carry["agc"])
        # "iq": kept (learned factors persist across discontinuities)
        return out

    # ------------------------------ step --------------------------------------

    def _step(self, carry: dict, raw: jnp.ndarray, reset: jnp.ndarray):
        """raw: (C, n_in * items) wire array -> (carry, (C, n_out * items)).

        The entire step runs on planar float32 (xr, xi) planes; see
        _build_carry for why.
        """
        cfg = self.cfg
        carry = jax.lax.cond(reset, self._reset_carry, lambda c: c, carry)
        new = dict(carry)

        xr, xi = convert.to_planar(raw, self.fmt_in, cfg.gain)
        if cfg.dc_block:
            xr, xi, new["dc"] = dc_block.apply_planar(
                xr, xi, carry["dc"], self.dc_alpha)
        if cfg.iq_correction:
            new["iq"] = iq_balance.maybe_update_planar(
                xr, xi, carry["iq"], self.iq_interval)
            xr, xi = iq_balance.apply_planar(xr, xi, new["iq"].factors)
        if int(self.dtheta_pre) != 0:
            xr, xi, new["nco_pre"] = nco.apply_planar(
                xr, xi, carry["nco_pre"], self.dtheta_pre)
        if self.pre_filter:
            xr, xi, nr, ni = self.pre_filter.apply_planar(
                xr, xi, *carry["pre_f"])
            new["pre_f"] = (nr, ni)
        if self.resampler:
            xr, xi, new["rs"] = self.resampler.apply_planar(
                xr, xi, carry["rs"])
        if self.post_filter:
            xr, xi, nr, ni = self.post_filter.apply_planar(
                xr, xi, *carry["post_f"])
            new["post_f"] = (nr, ni)
        # digital AGC: measure the block peak BEFORE the post-NCO, as the
        # folded and sharded steps do.  Rotation preserves magnitude in
        # exact math, but the digital profile compares hard thresholds
        # (clip/strong, agc.c:180-209): a ~1-ulp rotation rounding could
        # flip a lock/ratchet decision and propagate a different gain
        # forever, so every path measures at the same point.
        dig_gain = None
        if self.agc_cfg is not None and self.agc_cfg.profile == "digital":
            pk = jnp.sqrt(jnp.max(xr * xr + xi * xi, axis=-1))
            dig_gain, new["agc"] = agc_ops.digital_update(
                carry["agc"], pk, xr.shape[-1], self.agc_cfg)
        if int(self.dtheta_post) != 0:
            xr, xi, new["nco_post"] = nco.apply_planar(
                xr, xi, carry["nco_post"], self.dtheta_post)
        if self.agc_cfg:
            if dig_gain is not None:
                xr, xi = xr * dig_gain[:, None], xi * dig_gain[:, None]
            else:
                xr, xi, new["agc"] = agc_ops.apply_planar(
                    xr, xi, carry["agc"], self.agc_cfg)
        out = convert.from_planar(xr, xi, self.fmt_out)
        return new, out

    @property
    def step(self):
        """The jitted step (carry donated for in-place buffer reuse)."""
        if self._jitted is None:
            self._jitted = jax.jit(self._step, donate_argnums=(0,))
        return self._jitted

    # --------------------------- accounting -----------------------------------

    def expected_out_frames(self, in_frames: int) -> int:
        """Total output frames the stream should yield for in_frames inputs
        (used by the host to trim the padded final block)."""
        if not self.resampler:
            return in_frames
        p, q = self.resampler.plan.p, self.resampler.plan.q
        return in_frames * p // q
