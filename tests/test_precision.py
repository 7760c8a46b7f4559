"""Every float32 dot_general the chain traces carries precision.DOT,
including the dots inside the GPU banded kernel (traced, not lowered,
here; 2^18-frame blocks give its maps enough windows to engage)."""

import jax
import numpy as np
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

import chip_smoke
from iq_tool_tpu.ops import banded_kernel
from iq_tool_tpu.ops.precision import DOT
from iq_tool_tpu.parallel import ShardedChain, make_mesh
from iq_tool_tpu.pipeline.chain import Chain
from iq_tool_tpu.pipeline.folded import FoldedChain

CONFIGS = chip_smoke.bench_configs(2, 1 << 18)


def _sub_jaxprs(params):
    for v in params.values():
        for item in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(item, ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, Jaxpr):
                yield item


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in _sub_jaxprs(eqn.params):
            yield from _dots(sub)


def _f32_dot_precisions(chain, channels):
    carry = jax.eval_shape(lambda: chain._build_carry(channels))
    raw = jax.ShapeDtypeStruct((channels, chain.in_wire_len),
                               chain.in_wire_dtype)
    closed = jax.make_jaxpr(chain._step)(carry, raw, np.False_)
    return [e.params["precision"] for e in _dots(closed.jaxpr)
            if all(v.aval.dtype == np.float32 for v in e.invars)]


def _check(precisions):
    assert precisions, "no float32 dot traced"
    for p in precisions:
        assert p in (DOT, (DOT, DOT)), p


@pytest.mark.parametrize("name", list(CONFIGS))
def test_chain_step_dots_use_one_precision(name):
    cfg = CONFIGS[name]
    _check(_f32_dot_precisions(Chain(cfg), cfg.channels))


def test_kernel_dots_are_traced():
    """The flagship step at bench width routes stage 0 to the kernel, so
    the check above also covers the kernel's tile dots."""
    cfg = CONFIGS["flagship"]
    chain = Chain(cfg)
    carry = jax.eval_shape(lambda: chain._build_carry(cfg.channels))
    raw = jax.ShapeDtypeStruct((cfg.channels, chain.in_wire_len),
                               chain.in_wire_dtype)
    closed = jax.make_jaxpr(chain._step)(carry, raw, np.False_)
    shapes = {tuple(v.aval.shape) for e in _dots(closed.jaxpr)
              for v in e.invars}
    assert (banded_kernel.TB, banded_kernel.TK) in shapes


def test_folded_step_dots_use_one_precision():
    cfg = CONFIGS["flagship"]
    fc = FoldedChain(cfg, fold=4)
    _check(_f32_dot_precisions(fc, fc.channels))


def test_sharded_step_dots_use_one_precision():
    cfg = CONFIGS["flagship"]
    sc = ShardedChain(cfg, make_mesh(jax.devices()[:4], 2, 2))
    carry = jax.eval_shape(sc.init_carry)
    raw = jax.ShapeDtypeStruct((cfg.channels, sc.in_wire_len),
                               sc.in_wire_dtype)
    closed = jax.make_jaxpr(sc.step)(carry, raw, np.False_)
    _check([e.params["precision"] for e in _dots(closed.jaxpr)
            if all(v.aval.dtype == np.float32 for v in e.invars)])
