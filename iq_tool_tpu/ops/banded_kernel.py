"""Banded window-matmul as one Pallas kernel on the Triton route (GPU).

Computes the same map as the XLA path of ``banded.apply_planar``,

    y[c, b*G + g] = sum_l ext[c, b*S + l] * A[l, g],   ext = state ++ x,

without writing the overlapping windows (or the ``state ++ x``
concatenation) to device memory: each program gathers its window tile
straight from ``state`` and ``x`` in global memory.

The banded matrix A is mostly zero: output column g reads only the rows
around its anchor.  A program owns TB windows x TG output columns and
walks only the rows its column tile touches (``band_tiles``), so it
issues a fraction of the dense matmul's multiply-adds.  Dots run at
``precision.DOT`` (IEEE float32 on this route).  Tile sizes come from a
sweep on an H100; the Triton route needs every dot operand dimension to
be at least 16.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from iq_tool_tpu.ops.precision import DOT

TB = 64        # windows per program
TG = 128       # output columns per program
TK = 16        # matrix rows per inner step
NUM_WARPS = 4
NUM_STAGES = 3


def band_tiles(a_r: np.ndarray, a_i: np.ndarray | None):
    """(first row per column tile (int32), inner steps): column tile j
    reads rows [lo[j], lo[j] + steps * TK) of A, which hold every nonzero
    of its columns (rows past the end are masked to zero)."""
    nz = a_r != 0
    if a_i is not None:
        nz = nz | (a_i != 0)
    g = a_r.shape[1]
    lo = np.zeros(-(-g // TG), np.int32)
    width = 1
    for j in range(len(lo)):
        rows = np.nonzero(nz[:, j * TG:(j + 1) * TG].any(axis=1))[0]
        if rows.size:
            lo[j] = rows[0]
            width = max(width, int(rows[-1]) + 1 - int(rows[0]))
    return lo, -(-width // TK)


def _kernel(lo_ref, sr_ref, si_ref, xr_ref, xi_ref, *rest, s, hist, nb, l, g,
            steps, complex_taps):
    if complex_taps:
        ar_ref, ai_ref, yr_ref, yi_ref = rest
    else:
        (ar_ref, yr_ref, yi_ref), ai_ref = rest, None
    i, j = pl.program_id(1), pl.program_id(2)
    rows = i * TB + jnp.arange(TB, dtype=jnp.int32)
    cols = j * TG + jnp.arange(TG, dtype=jnp.int32)
    row_ok = rows < nb
    col_ok = cols < g
    k_lo = lo_ref[j]

    def body(t, acc):
        k = k_lo + t * TK + jnp.arange(TK, dtype=jnp.int32)
        k_ok = k < l
        e = rows[:, None] * s + k[None, :]              # index into ext
        ok = row_ok[:, None] & k_ok[None, :]
        in_state = e < hist
        st_idx = jnp.minimum(e, hist - 1)
        x_idx = jnp.maximum(e - hist, 0)

        def window(st_ref, x_ref):
            a = plgpu.load(st_ref.at[st_idx], mask=ok & in_state, other=0.0)
            b = plgpu.load(x_ref.at[x_idx], mask=ok & ~in_state, other=0.0)
            return jnp.where(in_state, a, b)

        a_ok = k_ok[:, None] & col_ok[None, :]
        a_rows, a_cols = jnp.minimum(k, l - 1), jnp.minimum(cols, g - 1)

        def mat(ref):
            return plgpu.load(ref.at[a_rows[:, None], a_cols[None, :]],
                              mask=a_ok, other=0.0)

        wr, wi = window(sr_ref, xr_ref), window(si_ref, xi_ref)
        ar = mat(ar_ref)
        acc_r = acc[0] + pl.dot(wr, ar, precision=DOT)
        acc_i = acc[1] + pl.dot(wi, ar, precision=DOT)
        if complex_taps:
            ai = mat(ai_ref)
            acc_r = acc_r - pl.dot(wi, ai, precision=DOT)
            acc_i = acc_i + pl.dot(wr, ai, precision=DOT)
        return acc_r, acc_i

    zero = jnp.zeros((TB, TG), jnp.float32)
    acc_r, acc_i = jax.lax.fori_loop(0, steps, body, (zero, zero))
    # masked lanes point one past the end: never written (the interpreter
    # drops out-of-range scatter lanes instead of storing stale values)
    ok = row_ok[:, None] & col_ok[None, :]
    out = jnp.where(ok, rows[:, None] * g + cols[None, :], nb * g)
    plgpu.store(yr_ref.at[out], acc_r, mask=ok)
    plgpu.store(yi_ref.at[out], acc_i, mask=ok)


def apply(state_r, state_i, xr, xi, a_r: np.ndarray, a_i: np.ndarray | None,
          stride: int, hist: int, interpret: bool = False):
    """Banded map over a (C, n) block with (C, hist) carried history.

    Same contract as ``banded.apply_planar``: returns (yr, yi), each
    (C, (n // stride) * G) float32.  ``hist`` must be positive.
    """
    ch, n = xr.shape
    l, g = a_r.shape
    if hist <= 0 or l != stride + hist:
        raise ValueError(f"banded kernel needs 0 < hist and A rows == "
                         f"stride + hist (got {a_r.shape}, {stride}, {hist})")
    nb = n // stride
    complex_taps = a_i is not None and bool(np.any(a_i))
    lo, steps = band_tiles(a_r, a_i if complex_taps else None)
    mats = [jnp.asarray(a_r)] + ([jnp.asarray(a_i)] if complex_taps else [])
    kern = functools.partial(_kernel, s=stride, hist=hist, nb=nb, l=l, g=g,
                             steps=steps, complex_taps=complex_taps)
    row = lambda w: pl.BlockSpec((None, w), lambda c, i, j: (c, 0))
    out = jax.ShapeDtypeStruct((ch, nb * g), jnp.float32)
    yr, yi = pl.pallas_call(
        kern,
        grid=(ch, -(-nb // TB), len(lo)),
        in_specs=[pl.BlockSpec(lo.shape, lambda c, i, j: (0,)),
                  row(hist), row(hist), row(n), row(n)]
                 + [pl.BlockSpec((l, g), lambda c, i, j: (0, 0))
                    for _ in mats],
        out_specs=[row(nb * g), row(nb * g)],
        out_shape=[out, out],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name="banded_window_matmul",
    )(jnp.asarray(lo), state_r, state_i, xr, xi, *mats)
    return yr, yi
