"""The banded window-matmul against a direct numpy sum: the XLA path
(ops/banded.py) and the GPU kernel (ops/banded_kernel.py, in Pallas
interpret mode here), plus the static choice between them.

y[c, b*G + g] = sum_l ext[c, b*S + l] * A[l, g] with ext = state ++ x,
over resampler stages (history shorter and longer than the stride,
upsampling and deep decimation), FIR Toeplitz maps, complex matrices
and several channel counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iq_tool_tpu.ops import banded, banded_kernel
from iq_tool_tpu.ops.filters import _toeplitz
from iq_tool_tpu.ops.resample import _MatmulStage


def _reference(state, x, a, stride):
    ext = np.concatenate([state, x], axis=-1).astype(np.complex128)
    l, g = a.shape
    nb = x.shape[-1] // stride
    win = np.stack([ext[:, b * stride:b * stride + l] for b in range(nb)], 1)
    return (win @ a.astype(np.complex128)).reshape(x.shape[0], nb * g)


def _stage(p, q, n_in, fir=None):
    st = _MatmulStage(p, q, n_in, 60.0, 16)
    if fir is not None:
        st.compose_input_fir(fir)
    return st._a, st._a_i, st.stride, st.hist


def _fir(taps, stride):
    tr = _toeplitz(taps.real.astype(np.float32), stride)
    ti = (_toeplitz(taps.imag.astype(np.float32), stride)
          if np.any(taps.imag) else None)
    return tr, ti, stride, len(taps) - 1


_RNG = np.random.default_rng(7)
_CPLX = np.exp(1j * 0.4 * np.arange(13)) / 13
GEOMETRIES = {
    "441/512": lambda c: _stage(441, 512, 2048, _CPLX if c else None),
    "27/32": lambda c: _stage(27, 32, 4096, _CPLX if c else None),
    "3/4": lambda c: _stage(3, 4, 400, _CPLX if c else None),
    "up 5/3": lambda c: _stage(5, 3, 960, _CPLX if c else None),
    "decim 1/8": lambda c: _stage(1, 8, 2048, _CPLX if c else None),
    "fir 31 @ 64": lambda c: _fir(_RNG.standard_normal(31)
                                  + (1j * _RNG.standard_normal(31) if c
                                     else 0), 64),
    "fir 257 @ 128": lambda c: _fir(_RNG.standard_normal(257)
                                    + (1j * _RNG.standard_normal(257) if c
                                       else 0), 128),
    "fir 75 @ 256": lambda c: _fir(_RNG.standard_normal(75)
                                   + (1j * _RNG.standard_normal(75) if c
                                      else 0), 256),
}


ENGINES = {
    "xla": banded.apply_planar,
    "kernel": lambda *a: banded_kernel.apply(*a, interpret=True),
}


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("complex_a", [False, True])
@pytest.mark.parametrize("geom", list(GEOMETRIES))
@pytest.mark.parametrize("engine", list(ENGINES))
def test_apply_planar_matches_direct_sum(rng, engine, geom, complex_a,
                                         channels):
    a_r, a_i, stride, hist = GEOMETRIES[geom](complex_a)
    assert (a_i is not None) == complex_a
    n = 4 * stride
    x = rng.standard_normal((2, channels, n)).astype(np.float32)
    st = rng.standard_normal((2, channels, hist)).astype(np.float32)
    yr, yi = ENGINES[engine](st[0], st[1], x[0], x[1], a_r, a_i,
                             stride, hist)
    a = a_r + (1j * a_i if a_i is not None else 0)
    want = _reference(st[0] + 1j * st[1], x[0] + 1j * x[1], a, stride)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("n,hist", [(100, 31), (20, 31), (31, 31)])
def test_new_tail(rng, n, hist):
    """The next carry is the last hist samples of state ++ x, also when
    the block is shorter than the history."""
    st = rng.standard_normal((2, hist)).astype(np.float32)
    x = rng.standard_normal((2, n)).astype(np.float32)
    want = np.concatenate([st, x], axis=-1)[:, -hist:]
    np.testing.assert_array_equal(np.asarray(banded.new_tail(st, x, hist)),
                                  want)


@pytest.mark.parametrize("stride,hist,windows,want", [
    (512, 31, 512, True), (256, 287, 882, True), (256, 31, 882, False),
    (256, 74, 1024, False), (512, 31, 32, False), (1024, 0, 512, False)])
def test_use_kernel_rule(stride, hist, windows, want):
    """The kernel serves maps whose window reaches KERNEL_MIN_WINDOW
    samples, with at least KERNEL_MIN_WINDOWS windows per row."""
    assert banded.use_kernel(stride, hist, windows) is want


@pytest.mark.parametrize("geom,platform,windows,want", [
    ("441/512", "cuda", 512, True), ("441/512", "cpu", 512, False),
    ("441/512", "cuda", 32, False), ("27/32", "cuda", 1024, False)])
def test_kernel_lowered_only_for_gpu(geom, platform, windows, want):
    """apply_planar lowers to the Triton kernel for CUDA when the map
    pays, and to plain XLA otherwise (checked by lowering here)."""
    a_r, a_i, stride, hist = GEOMETRIES[geom](False)
    x = jnp.zeros((2, windows * stride), jnp.float32)
    st = jnp.zeros((2, hist), jnp.float32)
    f = jax.jit(lambda s0, s1, x0, x1: banded.apply_planar(
        s0, s1, x0, x1, a_r, a_i, stride, hist))
    text = f.trace(st, st, x, x).lower(
        lowering_platforms=(platform,)).as_text()
    assert ("xla.gpu.triton" in text) is want


def test_band_tiles_cover_every_nonzero(rng):
    """Each column tile's row window holds all of its columns' nonzeros."""
    a_r, a_i, _, _ = GEOMETRIES["27/32"](True)
    lo, steps = banded_kernel.band_tiles(a_r, a_i)
    nz = (a_r != 0) | (a_i != 0)
    for j, start in enumerate(lo):
        rows = np.nonzero(nz[:, j * banded_kernel.TG:
                             (j + 1) * banded_kernel.TG].any(axis=1))[0]
        assert start <= rows[0]
        assert rows[-1] < start + steps * banded_kernel.TK
