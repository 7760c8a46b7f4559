"""iq_tool_tpu — an I/Q stream-processing framework on JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
``pclov3r/iq_tool`` C tool (reference: /root/reference).  Instead of a
5–8-thread CPU pipeline over liquid-dsp calls, the whole DSP chain
(format-convert → DC-block → I/Q-imbalance-correct → frequency-shift →
FIR/FFT filter → arbitrary-ratio resample → filter → shift → AGC →
format-convert) is a single jit-compiled block program
``step(carry, raw_block) -> (carry, out_block)`` over fixed-shape
``(channels, block)`` complex64 arrays, with all sequential stream state
(NCO phase, IIR state, filter tails, polyphase history, AGC gain) carried
explicitly in a pytree.

Multi-device scaling uses ``jax.sharding.Mesh`` + ``shard_map`` over a
(channel, time) mesh: channels are embarrassingly parallel; the time axis
exchanges filter-history halos with a single ``ppermute`` per stateful
stage per step (reference analog: the sequential carry discipline of
filter.c:491-526 / frequency_shift.c:102 / dc_block.c:68).
"""

__version__ = "0.1.0"

from iq_tool_tpu.formats import SampleFormat, get_format, FORMATS  # noqa: F401
