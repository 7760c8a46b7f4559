"""DC blocker: matches the scalar IIR recurrence, removes DC, streams."""

import numpy as np
import pytest

from iq_tool_tpu.ops import dc_block


def _scalar_ref(x, alpha):
    """Direct per-sample H(z) = (1 - z^-1)/(1 - (1-a) z^-1) (dc_block.c)."""
    a = 1.0 - alpha
    y = np.zeros_like(x)
    x_prev = 0.0 + 0.0j
    y_prev = 0.0 + 0.0j
    for i in range(len(x)):
        y[i] = x[i] - x_prev + a * y_prev
        x_prev = x[i]
        y_prev = y[i]
    return y


def test_matches_scalar_recurrence(rng):
    alpha = dc_block.alpha_for_rate(2_048_000.0)
    x = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)).astype(np.complex64)
    got, _ = dc_block.apply(x[None, :], dc_block.init(1), alpha)
    want = _scalar_ref(x.astype(np.complex128), alpha)
    np.testing.assert_allclose(np.asarray(got)[0], want, atol=2e-4)


def test_removes_dc(rng):
    alpha = dc_block.alpha_for_rate(100_000.0)
    n = 65536
    x = (0.7 + 0.3j) * np.ones(n, np.complex64)
    x += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    state = dc_block.init(1)
    y, state = dc_block.apply(x[None, :], state, alpha)
    tail = np.asarray(y)[0][-1000:]
    assert np.abs(tail.mean()) < 0.01  # DC gone (input DC was ~0.76)


def test_streaming_equals_batch(rng):
    alpha = dc_block.alpha_for_rate(48_000.0)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    full, _ = dc_block.apply(x[None, :], dc_block.init(1), alpha)
    state = dc_block.init(1)
    parts = []
    for i in range(0, 4096, 1024):
        y, state = dc_block.apply(x[None, i:i + 1024], state, alpha)
        parts.append(np.asarray(y)[0])
    np.testing.assert_allclose(np.concatenate(parts), np.asarray(full)[0],
                               rtol=0, atol=1e-5)


def test_reset():
    state = dc_block.DcState(
        np.ones(3).astype(np.complex64), np.ones(3).astype(np.complex64))
    r = dc_block.reset(state)
    assert np.all(np.asarray(r.x_prev) == 0) and np.all(np.asarray(r.y_prev) == 0)


# (block length, blocks per stream, sample rate): tiled blocks (tile 256
# and 250), blocks at or under one tile (flat associative scan), and a
# prime length with no tile divisor >= 32 (flat scan over a long block)
SCAN_CASES = [
    (4096, 3, 2_048_000.0),
    (1000, 4, 2_048_000.0),
    (256, 5, 48_000.0),
    (31, 6, 48_000.0),
    (4099, 2, 2_048_000.0),
    (16384, 2, 1_000.0),
    (262144, 1, 2_048_000.0),
]


@pytest.mark.parametrize("n,blocks,rate", SCAN_CASES)
def test_two_level_scan_matches_recurrence(rng, n, blocks, rate):
    """The tiled prefix (triangular tile matmul + cross-tile scan)
    streamed over several blocks equals the scalar float64 recurrence
    on the whole stream."""
    alpha = dc_block.alpha_for_rate(rate)
    x = (rng.standard_normal((2, n * blocks))
         + 1j * rng.standard_normal((2, n * blocks))).astype(np.complex64)
    state = dc_block.init(2)
    parts = []
    for b in range(blocks):
        y, state = dc_block.apply(x[:, b * n:(b + 1) * n], state, alpha)
        parts.append(np.asarray(y))
    got = np.concatenate(parts, axis=-1)
    for c in range(2):
        want = _scalar_ref(x[c].astype(np.complex128), alpha)
        np.testing.assert_allclose(got[c], want, atol=5e-4)


@pytest.mark.parametrize("n,tile", [(4096, 256), (1000, 250), (256, 256),
                                    (4099, 0), (64, 64), (96, 96)])
def test_tile_size(n, tile):
    """The scan tiles by the largest divisor of n in [32, 256] (0: none,
    the flat associative scan runs instead)."""
    assert dc_block._tile_size(n) == tile
