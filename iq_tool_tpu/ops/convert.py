"""On-device sample-format conversion (wire ints <-> complex64).

Implements the exact integer quantization contracts of the reference's
src/sample_convert.c so that pipeline output is bit-for-byte comparable
after quantization:

* wire -> cf32 (sample_convert.c:127-202): per-format normalizer; unsigned
  formats subtract the mid-code offset first; gain is applied here.
* cf32 -> wire (sample_convert.c:40-73, 213-303): signed formats scale by
  TYPE_MAX (sc16q11: 2048, cs24: 2^23-1), round half away from zero, clamp
  to [TYPE_MIN, TYPE_MAX]; unsigned formats scale/offset, clamp to
  [0, TYPE_MAX], then floor(x + 0.5).

The host never touches sample math: raw bytes are reinterpreted as integer
arrays (or uint8 for packed cs24) and shipped to the device, so the
PCIe/host link carries the narrow wire format, not float32.

Deviation from the reference: cs32/cu32 use float64 intermediates in C
(sample_convert.c:176-202, 268-303); the device path runs float32
throughout (JAX's 64-bit mode stays off), so those two formats use f32
intermediates here (error < 2^-24 full scale, far inside
the 60 dB chain SNR budget).  All 8/16/24-bit formats are bit-exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from iq_tool_tpu.formats import SampleFormat, get_format


def _require_complex(fmt: SampleFormat) -> None:
    if not fmt.is_complex:
        raise ValueError(
            f"format '{fmt.name}' is real; the pipeline processes complex I/Q "
            "streams only (matching the reference's convert_block_to_cf32)")


def wire_dtype(fmt: SampleFormat | str) -> np.dtype:
    """The numpy dtype host code should use to view the raw byte stream."""
    fmt = get_format(fmt) if isinstance(fmt, str) else fmt
    return np.dtype(np.uint8) if fmt.wire_dtype is None else fmt.wire_dtype


def wire_items_per_frame(fmt: SampleFormat | str) -> int:
    fmt = get_format(fmt) if isinstance(fmt, str) else fmt
    return fmt.items_per_frame


def to_planar(raw: jnp.ndarray, fmt: SampleFormat | str, gain: float = 1.0):
    """Convert a wire-format block to planar float32 (xr, xi).

    ``raw``: (..., N*items_per_frame) array of ``wire_dtype(fmt)``
    (uint8 bytes for cs24).  Returns two (..., N) float32 planes.
    The planar pair is the chain's internal representation: complex64
    ops decompose into plane arithmetic under XLA anyway, and the Pallas
    banded kernel has no complex dtype at all.
    """
    fmt = get_format(fmt) if isinstance(fmt, str) else fmt
    _require_complex(fmt)
    n = raw.shape[-1] // fmt.items_per_frame

    if fmt.name == "cf32":
        pairs = raw.reshape(*raw.shape[:-1], n, 2).astype(jnp.float32)
        g = jnp.float32(gain)
        return pairs[..., 0] * g, pairs[..., 1] * g

    if fmt.name == "cs24":
        b = raw.reshape(*raw.shape[:-1], n, 6).astype(jnp.int32)
        # little-endian 3-byte sign extension, sample_convert.c:156-166
        i_val = ((b[..., 0] << 8) | (b[..., 1] << 16) | (b[..., 2] << 24)) >> 8
        q_val = ((b[..., 3] << 8) | (b[..., 4] << 16) | (b[..., 5] << 24)) >> 8
        scale = jnp.float32(fmt.normalizer * gain)
        return i_val.astype(jnp.float32) * scale, q_val.astype(jnp.float32) * scale

    pairs = raw.reshape(*raw.shape[:-1], n, 2).astype(jnp.float32)
    if not fmt.signed:
        pairs = pairs - jnp.float32(fmt.offset)
    # Match the C operation order: (x * normalizer) * gain, both f32.
    pairs = (pairs * jnp.float32(fmt.normalizer)) * jnp.float32(gain)
    return pairs[..., 0], pairs[..., 1]


def to_cf32(raw: jnp.ndarray, fmt: SampleFormat | str, gain: float = 1.0):
    """Convert a wire-format block to complex64 (see to_planar)."""
    xr, xi = to_planar(raw, fmt, gain)
    return jax.lax.complex(xr, xi).astype(jnp.complex64)


def _round_half_away(x: jnp.ndarray) -> jnp.ndarray:
    # C: (x > 0) ? x + 0.5 : x - 0.5, then truncating cast.
    return jnp.trunc(jnp.where(x > 0, x + 0.5, x - 0.5))


def _safe_f32_bound(value: float, upper: bool) -> np.float32:
    """Largest/smallest float32 clamp bound that casts to an in-range int.

    2^31-1 and 2^32-1 round UP in float32; clamping to them and casting
    would wrap.  Step to the nearest representable value inside the range.
    """
    f = np.float32(value)
    if upper and float(f) > value:
        f = np.nextafter(f, np.float32(-np.inf))
    elif not upper and float(f) < value:
        f = np.nextafter(f, np.float32(np.inf))
    return f


def from_cf32(x: jnp.ndarray, fmt: SampleFormat | str) -> jnp.ndarray:
    """Quantize complex64 (..., N) to the wire format, (..., N*items)."""
    return from_planar(jnp.real(x), jnp.imag(x), fmt)


def from_planar(xr: jnp.ndarray, xi: jnp.ndarray,
                fmt: SampleFormat | str) -> jnp.ndarray:
    """Quantize planar float32 (..., N) planes to the wire format."""
    fmt = get_format(fmt) if isinstance(fmt, str) else fmt
    _require_complex(fmt)
    x = xr  # for shape bookkeeping below

    if fmt.name == "cf32":
        out = jnp.stack([xr, xi], axis=-1).astype(jnp.float32)
        return out.reshape(*x.shape[:-1], -1)

    pairs = jnp.stack([xr, xi], axis=-1).astype(jnp.float32)

    if fmt.signed:
        v = pairs * jnp.float32(fmt.scale)
        v = _round_half_away(v)
        v = jnp.clip(v, _safe_f32_bound(fmt.min_code, upper=False),
                     _safe_f32_bound(fmt.max_code, upper=True))
        codes = v.astype(jnp.int32)
    else:
        v = pairs * jnp.float32(fmt.scale) + jnp.float32(fmt.offset_out)
        v = jnp.clip(v, 0.0, _safe_f32_bound(fmt.max_code, upper=True))
        codes = jnp.floor(v + 0.5).astype(jnp.uint32)

    if fmt.name == "cs24":
        c = codes.astype(jnp.uint32)
        out = jnp.stack([c & 0xFF, (c >> 8) & 0xFF, (c >> 16) & 0xFF], axis=-1)
        return out.reshape(*x.shape[:-1], -1).astype(jnp.uint8)

    wd = fmt.wire_dtype
    out = codes.astype(wd)
    return out.reshape(*x.shape[:-1], -1)


# --------- host-side helpers (numpy, zero-copy where possible) ---------------

def bytes_to_wire(buf: bytes | np.ndarray, fmt: SampleFormat | str) -> np.ndarray:
    """View a raw byte buffer as the wire array expected by ``to_cf32``."""
    fmt = get_format(fmt) if isinstance(fmt, str) else fmt
    a = np.frombuffer(buf, dtype=wire_dtype(fmt)) if not isinstance(buf, np.ndarray) else buf
    return a


def wire_to_bytes(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr).tobytes()
