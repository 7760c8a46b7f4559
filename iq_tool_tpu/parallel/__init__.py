"""Multi-device scaling: shard_map over a (channel, time) mesh.

The reference's only parallelism is a 5-8 thread stage pipeline
(pipeline.c:96-116); the JAX equivalents (SURVEY.md section 2f):

* channel axis = pure data parallelism over independent streams;
* time axis   = sequence parallelism over one stream's samples, with the
  sequential DSP state flowing between shards: filter tails / resampler
  histories are halo-exchanged with ONE ppermute per stateful stage per
  step, NCO phases are closed-form per shard (no exchange), the DC IIR
  uses an exact cross-shard prefix correction, and AGC gathers per-segment
  energies so its gain trajectory is bit-identical to the sequential scan.
"""

from iq_tool_tpu.parallel.sharded import ShardedChain, make_mesh  # noqa: F401
