"""The one matmul precision of the signal path.

Every float32 dot in the chain (banded maps, the DC block's tile prefix,
the gather resampler) runs at ``DOT``.  Float32 products at any lower
setting may run as single-pass TF32 on the GPU (10-bit mantissa), which
puts tap rounding at the edge of the 60 dB design-attenuation contract
(constants.h:137).  HIGHEST is IEEE float32 on XLA:GPU and XLA:CPU alike.
"""

import jax

DOT = jax.lax.Precision.HIGHEST
