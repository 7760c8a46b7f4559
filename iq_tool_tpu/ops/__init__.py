"""DSP kernels (the numeric core).

JAX replacements for the liquid-dsp primitives the reference wraps
(SURVEY.md section 2b): sample conversion, DC block, NCO frequency shift,
I/Q imbalance correction, FIR/FFT filtering + Kaiser design, polyphase
rational resampling, and AGC.  All kernels operate on fixed-shape
``(channels, block)`` arrays and thread explicit carry state, so the whole
chain fuses under one ``jax.jit``.
"""

from iq_tool_tpu.ops import convert  # noqa: F401
