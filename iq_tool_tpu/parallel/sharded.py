"""Time- and channel-sharded execution of the DSP chain.

Design (SURVEY.md sections 2f and 5 "long-context" notes):

The stream is an infinite sequence of steps; each step processes a global
block of ``T * n_sub`` samples, laid out over a mesh axis ``time`` with T
shards (and independent channels over axis ``channel``).  Every stateful
stage needs the samples immediately PRECEDING each shard's sub-block:

* for shard i>0 that is the tail of shard i-1's sub-block THIS step -> one
  ``ppermute`` ring shift;
* for shard 0 it is the tail of shard T-1's sub-block from the PREVIOUS
  step -> exactly the value the same ppermute wraps around to shard 0,
  saved in the carry.

So each stateful stage costs ONE ppermute of its (C, H) tail per step, and
the carry is the ppermute result (only shard 0's slot is consumed).

Sequential recurrences that cross shards:

* DC IIR: shard-local scan from zero + exact prefix correction computed
  from all-gathered per-shard summaries (first-order linear recurrence
  composition) — bit-identical to the sequential scan up to f32 rounding;
* RMS AGC: per-segment energies are all-gathered and the gain scan runs
  (redundantly, replicated) over the full segment sequence — identical
  gain trajectory to single-device execution;
* digital AGC: block peak = pmax over time (one block per step);
* NCO: closed-form phase offset idx * n_sub * dtheta (uint32, exact);
* I/Q estimation: shard 0's first 1024 samples are broadcast (masked
  psum) and the deterministic grid update runs replicated.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from iq_tool_tpu import constants as C
from iq_tool_tpu.ops import agc as agc_ops
from iq_tool_tpu.ops import convert, iq_balance, nco
from iq_tool_tpu.pipeline.chain import Chain, ChainConfig


def make_mesh(devices=None, channel_shards: int | None = None,
              time_shards: int | None = None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if channel_shards is None and time_shards is None:
        channel_shards, time_shards = 1, n
    elif channel_shards is None:
        channel_shards = n // time_shards
    elif time_shards is None:
        time_shards = n // channel_shards
    if channel_shards * time_shards != n:
        raise ValueError(f"{channel_shards}x{time_shards} != {n} devices")
    arr = np.asarray(devices).reshape(channel_shards, time_shards)
    return Mesh(arr, ("channel", "time"))


class ShardedChain:
    """A chain whose step runs under shard_map over a (channel, time) mesh.

    Global geometry: channels = cfg.channels (divisible by the channel
    axis), block = T * per-shard block.  The wire layout is
    (channels, n_in * items) like the single-chip chain, just bigger.
    """

    def __init__(self, cfg: ChainConfig, mesh: Mesh):
        self.mesh = mesh
        self.t = mesh.shape["time"]
        self.c_shards = mesh.shape["channel"]
        if cfg.channels % self.c_shards:
            raise ValueError(
                f"channels {cfg.channels} not divisible by channel axis "
                f"{self.c_shards}")
        self.c_local = cfg.channels // self.c_shards
        # per-shard chain: same config at per-shard block size and local
        # channel count; all plans (filters, resampler) are shard-local.
        local_cfg = ChainConfig(**{**cfg.__dict__,
                                   "channels": self.c_local,
                                   "target_block": cfg.target_block})
        self.local = Chain(local_cfg)
        self.cfg = cfg
        if self.cfg.iq_correction and self.local.n_in < C.IQ_FFT_SIZE:
            raise ValueError("per-shard block too small for I/Q estimation")

        self.n_in = self.local.n_in * self.t
        self.n_out = self.local.n_out * self.t
        self.in_wire_len = self.n_in * self.local.fmt_in.items_per_frame
        self.out_wire_len = self.n_out * self.local.fmt_out.items_per_frame
        self.in_wire_dtype = self.local.in_wire_dtype
        self.out_wire_dtype = self.local.out_wire_dtype
        self._jitted = None

    # Chain-compatible surface so StreamEngine / the CLI can drive a
    # ShardedChain interchangeably (fmt/resampler live on the local chain)
    @property
    def fmt_in(self):
        return self.local.fmt_in

    @property
    def fmt_out(self):
        return self.local.fmt_out

    @property
    def resampler(self):
        return self.local.resampler

    # ------------------------------------------------------------------ carry

    def _carry_struct(self) -> dict:
        """Leaf name -> ('halo', H) for tail leaves or ('rep', make_fn(ch))."""
        lc = self.local
        leaves: dict = {}
        if int(lc.dtheta_pre) != 0:
            leaves["nco_pre"] = ("rep", nco.init)
        if int(lc.dtheta_post) != 0:
            leaves["nco_post"] = ("rep", nco.init)
        # halo leaves are PLANAR: width 2H = real tail ++ imag tail, so one
        # ppermute still moves a stage's whole state
        if lc.cfg.dc_block:
            leaves["dc_x"] = ("halo", 2 * 1)
            leaves["dc_y"] = ("rep",
                              lambda ch: jnp.zeros((ch, 2), jnp.float32))
        if lc.cfg.iq_correction:
            leaves["iq"] = ("rep", iq_balance.init)
        if lc.pre_filter:
            leaves["pre_f"] = ("halo", 2 * lc.pre_filter.block)
        if lc.resampler:
            for si, st in enumerate(lc.resampler.stages):
                # shape only: describing the carry runs nothing on a device
                h = jax.eval_shape(lambda s=st: s.init(1)).shape[-1]
                leaves[f"rs{si}"] = ("halo", 2 * h)
        if lc.post_filter:
            leaves["post_f"] = ("halo", 2 * lc.post_filter.block)
        if lc.agc_cfg:
            leaves["agc"] = ("rep", agc_ops.init)
        return leaves

    def init_carry(self, channels: int | None = None):
        if channels is not None and channels != self.cfg.channels:
            raise ValueError(
                f"carry channels {channels} != configured {self.cfg.channels}")
        struct = self._carry_struct()
        ch_global = self.cfg.channels

        def build():
            out = {}
            for name, spec in struct.items():
                if spec[0] == "halo":
                    out[name] = jnp.zeros((ch_global, self.t * spec[1]),
                                          jnp.float32)
                else:
                    # build global-channel-sized replicated leaves by
                    # re-invoking the maker at the global channel count
                    out[name] = spec[1](ch_global)
            return out

        specs = self.carry_specs()
        shardings = jax.tree_util.tree_map(
            lambda s: NamedSharding(self.mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P))
        return jax.jit(build, out_shardings=shardings)()

    def carry_specs(self) -> dict:
        """PartitionSpecs: halo leaves are (C, T*H) sharded (channel, time);
        replicated leaves are channel-sharded, time-replicated."""
        struct = self._carry_struct()
        specs = {}
        for name, spec in struct.items():
            if spec[0] == "halo":
                specs[name] = P("channel", "time")
            else:
                # abstract eval only: no device work to describe the carry
                example = jax.eval_shape(lambda s=spec: s[1](1))
                specs[name] = jax.tree_util.tree_map(
                    lambda v: P("channel") if getattr(v, "ndim", 0) >= 1
                    else P(), example)
        return specs

    # ------------------------------------------------------------------- step

    def _halo(self, tail: jnp.ndarray, carry_tail: jnp.ndarray):
        """tail: this shard's (C, H) trailing samples. Returns (use, new_carry):
        use = preceding samples for this shard; new_carry = the wrapped
        ppermute result (consumed by shard 0 next step).  T == 1 is a
        static no-op: the single shard's predecessor IS the carry and
        the wrap target IS its own tail — no collective, no select (a
        channel-only mesh pays zero stitch cost)."""
        t = self.t
        if t == 1:
            return carry_tail, tail
        recv = jax.lax.ppermute(tail, "time",
                                [(i, (i + 1) % t) for i in range(t)])
        idx = jax.lax.axis_index("time")
        use = jnp.where(idx == 0, carry_tail, recv)
        return use, recv

    def _dc_sharded_plane(self, x, x_prev_use, carry_y, alpha):
        """Exact cross-shard first-order IIR, one real plane (see module
        docstring).  Shard-local prefix reuses the two-level scan."""
        from iq_tool_tpu.ops.dc_block import _apply_plane
        n = x.shape[-1]
        if self.t == 1:
            # single time shard: the true carry goes straight into the
            # scan — no zero-start, no all_gather, no prefix compose
            y, _, end = _apply_plane(x, x_prev_use[:, 0], carry_y, alpha)
            return y, end
        # local scan from zero initial y, with the halo'd x[-1]
        y0, _, end0 = _apply_plane(x, x_prev_use[:, 0], jnp.zeros_like(carry_y),
                                   alpha)
        ends = jax.lax.all_gather(end0, "time")            # (T, C)
        a_real = 1.0 - alpha                               # python float
        a_l = jnp.float32(a_real ** n)
        starts = [carry_y]
        for j in range(1, self.t):
            starts.append(ends[j - 1] + a_l * starts[j - 1])
        starts_arr = jnp.stack(starts)                     # (T, C)
        idx = jax.lax.axis_index("time")
        start = starts_arr[idx]
        # a^(n+1) decay vector: numpy constant (a is real in (0,1))
        apow = np.power(a_real, np.arange(1, n + 1), dtype=np.float64)
        apow = apow.astype(np.float32)
        y = y0 + start[:, None] * apow[None, :]
        new_carry_y = ends[self.t - 1] + a_l * starts_arr[self.t - 1]
        return y, new_carry_y

    def _agc_sharded_gains(self, xr, xi, state, cfg, dig_pk=None):
        """(gains (C, n_seg) or (C, 1), seg, new_state): the per-shard
        gain schedule with the gain scan run over the GLOBAL
        (cross-shard) segment order (FoldedChain._agc_folded_gains's
        twin)."""
        if cfg.profile == "digital":
            # dig_pk is the PRE-post-NCO local peak measured in step()
            # (must match the single-device paths' measurement point)
            peak_local = (dig_pk if dig_pk is not None
                          else jnp.sqrt(jnp.max(xr * xr + xi * xi, axis=-1)))
            peak = jax.lax.pmax(peak_local, "time")
            n_total = xr.shape[-1] * self.t
            gain, new_state = agc_ops.digital_update(state, peak, n_total,
                                                     cfg)
            return gain[:, None], 0, new_state
        c, n = xr.shape
        n_seg, seg, beta = agc_ops.rms_params(cfg, n)
        xsr = xr[:, : n_seg * seg].reshape(c, n_seg, seg)
        xsi = xi[:, : n_seg * seg].reshape(c, n_seg, seg)
        e_local = jnp.mean(xsr * xsr + xsi * xsi, axis=-1).T  # (n_seg, C)
        e_all = jax.lax.all_gather(e_local, "time")        # (T, n_seg, C)
        e_flat = e_all.reshape(self.t * n_seg, c)
        gains, g_fin, e2_fin = agc_ops.rms_scan(
            e_flat, state.gain, state.e2, beta, cfg.target)
        idx = jax.lax.axis_index("time")
        my_gains = jax.lax.dynamic_slice_in_dim(gains, idx * n_seg, n_seg, 0)
        new_state = state._replace(
            gain=g_fin, e2=e2_fin,
            samples_seen=state.samples_seen + jnp.uint32(n * self.t))
        return my_gains.T, seg, new_state

    def _agc_sharded(self, xr, xi, state, cfg, dig_pk=None):
        gains, seg, new_state = self._agc_sharded_gains(xr, xi, state, cfg,
                                                        dig_pk)
        if seg == 0:
            g = gains
            return xr * g, xi * g, new_state
        c, n = xr.shape
        n_seg = gains.shape[-1]
        xsr = xr[:, : n_seg * seg].reshape(c, n_seg, seg)
        xsi = xi[:, : n_seg * seg].reshape(c, n_seg, seg)
        gseg = gains[:, :, None]
        yr = (xsr * gseg).reshape(c, n_seg * seg)
        yi = (xsi * gseg).reshape(c, n_seg * seg)
        if n_seg * seg < n:
            # ragged tail uses THIS shard's last gain (matches the
            # sequential per-block behavior of agc._apply_rms)
            g_last = gains[:, -1][:, None]
            yr = jnp.concatenate([yr, xr[:, n_seg * seg:] * g_last], -1)
            yi = jnp.concatenate([yi, xi[:, n_seg * seg:] * g_last], -1)
        return yr, yi, new_state

    def _local_step(self, carry: dict, raw: jnp.ndarray, reset: jnp.ndarray):
        """Runs per time/channel shard inside shard_map.

        raw: (C_local, n_sub * items); halo carry leaves arrive as
        (C_local, H) slices of the (C, T*H) global arrays."""
        lc = self.local
        cfg = lc.cfg
        # T == 1: a literal 0, so every t_idx == 0 select and masked psum
        # folds away at trace time
        t_idx = jnp.int32(0) if self.t == 1 else jax.lax.axis_index("time")
        n_sub = lc.n_in

        def reset_carry(cc):
            out = {}
            for name, v in cc.items():
                if name == "iq":
                    out[name] = v          # learned factors persist
                elif name == "agc":
                    out[name] = agc_ops.init(v.gain.shape[0])
                else:
                    out[name] = jax.tree_util.tree_map(jnp.zeros_like, v)
            return out

        carry = jax.lax.cond(reset, reset_carry, lambda cc: cc, carry)

        def tail2(xr, xi, h):
            """Planar stage tail, packed real ++ imag for one ppermute."""
            return jnp.concatenate([xr[:, -h:], xi[:, -h:]], axis=-1)

        new = dict(carry)
        xr, xi = convert.to_planar(raw, lc.fmt_in, cfg.gain)
        if cfg.dc_block:
            use, new["dc_x"] = self._halo(tail2(xr, xi, 1), carry["dc_x"])
            xr, cyr = self._dc_sharded_plane(
                xr, use[:, 0:1], carry["dc_y"][:, 0], lc.dc_alpha)
            xi, cyi = self._dc_sharded_plane(
                xi, use[:, 1:2], carry["dc_y"][:, 1], lc.dc_alpha)
            new["dc_y"] = jnp.stack([cyr, cyi], axis=-1)
        if cfg.iq_correction:
            # broadcast shard 0's leading 1024 samples (masked psum)
            nf = C.IQ_FFT_SIZE
            seg = jnp.concatenate([xr[:, :nf], xi[:, :nf]], axis=-1)
            seg0 = jnp.where(t_idx == 0, seg, jnp.zeros_like(seg))
            seg_b = jax.lax.psum(seg0, "time")
            new["iq"] = iq_balance.maybe_update_planar(
                seg_b[:, :nf], seg_b[:, nf:], carry["iq"], lc.iq_interval,
                advance_samples=self.t * n_sub)
            xr, xi = iq_balance.apply_planar(xr, xi, new["iq"].factors)
        if int(lc.dtheta_pre) != 0:
            phase = (carry["nco_pre"]
                     + t_idx.astype(jnp.uint32) * jnp.uint32(n_sub)
                     * lc.dtheta_pre)
            xr, xi, _ = nco.apply_planar(xr, xi, phase, lc.dtheta_pre)
            new["nco_pre"] = (carry["nco_pre"]
                              + jnp.uint32(self.t * n_sub) * lc.dtheta_pre)
        if lc.pre_filter:
            b = lc.pre_filter.block
            use, new["pre_f"] = self._halo(tail2(xr, xi, b), carry["pre_f"])
            xr, xi, _, _ = lc.pre_filter.apply_planar(
                xr, xi, use[:, :b], use[:, b:])
        if lc.resampler:
            for si, stage in enumerate(lc.resampler.stages):
                h = carry[f"rs{si}"].shape[-1] // 2
                use, new[f"rs{si}"] = self._halo(tail2(xr, xi, h),
                                                 carry[f"rs{si}"])
                xr, xi, _, _ = stage.apply_planar(
                    xr, xi, use[:, :h], use[:, h:])
        if lc.post_filter:
            b = lc.post_filter.block
            use, new["post_f"] = self._halo(tail2(xr, xi, b), carry["post_f"])
            xr, xi, _, _ = lc.post_filter.apply_planar(
                xr, xi, use[:, :b], use[:, b:])
        # digital AGC: measure the block peak pre-NCO, as Chain._step
        # does: the profile's hard thresholds must see the same float
        # value everywhere
        dig_pk = None
        if lc.agc_cfg is not None and lc.agc_cfg.profile == "digital":
            dig_pk = jnp.sqrt(jnp.max(xr * xr + xi * xi, axis=-1))
        if int(lc.dtheta_post) != 0:
            n_out_sub = lc.n_out
            phase = (carry["nco_post"]
                     + t_idx.astype(jnp.uint32) * jnp.uint32(n_out_sub)
                     * lc.dtheta_post)
            xr, xi, _ = nco.apply_planar(xr, xi, phase, lc.dtheta_post)
            new["nco_post"] = (carry["nco_post"]
                               + jnp.uint32(self.t * n_out_sub)
                               * lc.dtheta_post)
        if lc.agc_cfg:
            xr, xi, new["agc"] = self._agc_sharded(xr, xi, carry["agc"],
                                                   lc.agc_cfg, dig_pk)
        out = convert.from_planar(xr, xi, lc.fmt_out)
        return new, out

    @property
    def step(self):
        """jitted sharded step: (carry, raw (C, n_in*items), reset) ->
        (carry, out (C, n_out*items))."""
        if self._jitted is not None:
            return self._jitted
        specs = self.carry_specs()
        in_raw_spec = P("channel", "time")
        out_spec = P("channel", "time")

        f = jax.shard_map(
            self._local_step, mesh=self.mesh,
            in_specs=(specs, in_raw_spec, P()),
            out_specs=(specs, out_spec),
            check_vma=False,
        )
        self._jitted = jax.jit(f, donate_argnums=(0,))
        return self._jitted

    def expected_out_frames(self, in_frames: int) -> int:
        if not self.local.resampler:
            return in_frames
        p, q = self.local.resampler.plan.p, self.local.resampler.plan.q
        return in_frames * p // q
