"""Bit-exactness of on-device format conversion vs the numpy oracle
(contract: sample_convert.c rounding/clamping — SURVEY.md section 4 item 1)."""

import numpy as np
import pytest

from iq_tool_tpu.formats import get_format
from iq_tool_tpu.ops import convert
from tests import ref_dsp

EXACT_IN = ["cs8", "cu8", "cs16", "cu16", "sc16q11", "cs24", "cf32"]
EXACT_OUT = ["cs8", "cu8", "cs16", "cu16", "sc16q11", "cs24", "cf32"]


def _random_wire(rng, fmt_name, n_frames):
    fmt = get_format(fmt_name)
    if fmt.name == "cs24":
        return rng.integers(0, 256, size=n_frames * 6, dtype=np.uint8)
    if fmt.name == "cf32":
        return (rng.standard_normal(n_frames * 2) * 0.5).astype(np.float32)
    dt = fmt.wire_dtype
    info = np.iinfo(dt)
    return rng.integers(info.min, int(info.max) + 1, size=n_frames * 2, dtype=dt)


@pytest.mark.parametrize("fmt", EXACT_IN)
def test_to_cf32_bit_exact(rng, fmt):
    raw = _random_wire(rng, fmt, 4096)
    got = np.asarray(convert.to_cf32(raw, fmt, gain=1.0))
    want = ref_dsp.to_cf32(raw, fmt, gain=1.0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", EXACT_IN)
def test_to_cf32_with_gain(rng, fmt):
    raw = _random_wire(rng, fmt, 1024)
    got = np.asarray(convert.to_cf32(raw, fmt, gain=2.5))
    want = ref_dsp.to_cf32(raw, fmt, gain=2.5)
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("fmt", ["cs32", "cu32"])
def test_to_cf32_32bit_close(rng, fmt):
    # C uses double intermediates for 32-bit formats; the device path is f32.
    raw = _random_wire(rng, fmt, 4096)
    got = np.asarray(convert.to_cf32(raw, fmt, gain=1.0))
    want = ref_dsp.to_cf32(raw, fmt, gain=1.0)
    assert ref_dsp.snr_db(want, got) > 120.0


@pytest.mark.parametrize("fmt", EXACT_OUT)
def test_from_cf32_bit_exact(rng, fmt):
    x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)).astype(np.complex64)
    x *= 0.45
    # include exact halves, clipping extremes, zeros, and tiny values
    x[:8] = [0, 1.5, -1.5, 2.0, -2.0, 0.5 / 32767.0, -0.5 / 32767.0, 1.0]
    got = np.asarray(convert.from_cf32(x, fmt))
    want = ref_dsp.from_cf32(x, fmt)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["cs32", "cu32"])
def test_from_cf32_32bit_close(rng, fmt):
    x = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)).astype(np.complex64)
    x *= 0.45
    got = np.asarray(convert.from_cf32(x, fmt)).astype(np.float64)
    want = ref_dsp.from_cf32(x, fmt).astype(np.float64)
    # f32 intermediate: relative error bounded by 2^-23 of full scale
    assert np.max(np.abs(got - want)) <= 2 ** 31 * 2 ** -22


@pytest.mark.parametrize("fmt", ["sc16q11", "cf32"])
def test_roundtrip_idempotent(rng, fmt):
    """Formats whose normalizer and scale are reciprocal round-trip exactly.

    (Most reference formats normalize by 2^k but quantize by 2^k - 1
    (sample_convert.c), so dequantize->quantize is deliberately NOT the
    identity for them; sc16q11 uses 2048 both ways.)
    """
    raw = _random_wire(rng, fmt, 2048)
    x = convert.to_cf32(raw, fmt, gain=1.0)
    back = np.asarray(convert.from_cf32(x, fmt))
    np.testing.assert_array_equal(back, raw)


def test_batched_shapes(rng):
    raw = rng.integers(-32768, 32768, size=(4, 256 * 2), dtype=np.int16)
    out = convert.to_cf32(raw, "cs16")
    assert out.shape == (4, 256)
    back = convert.from_cf32(out, "cs16")
    assert back.shape == (4, 512)
