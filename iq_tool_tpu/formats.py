"""Sample-format registry.

Single source of truth for the 16 wire formats, mirroring the reference's
format table (utils.c:29-47) and per-sample byte sizes
(sample_convert.c:102-123).  Each format records how raw bytes map to
device arrays so conversion can run on the device (the host only reinterprets
bytes; all math happens in the jitted chain).
"""

from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass(frozen=True)
class SampleFormat:
    name: str
    description: str
    is_complex: bool
    bytes_per_frame: int            # one frame = one (I,Q) pair for complex
    wire_dtype: np.dtype | None     # numpy dtype of the raw stream (None: packed)
    items_per_frame: int            # wire items per frame (2 for complex, 6 for cs24 bytes)
    signed: bool
    # cf32 normalization (sample_convert.c:135-202):
    #   signed:   x_f = wire * normalizer
    #   unsigned: x_f = (wire - offset) * normalizer
    normalizer: float = 1.0
    offset: float = 0.0
    # cf32 -> wire quantization (sample_convert.c:40-73, 218-303):
    #   signed:   q = clamp(round_half_away(x * scale), min_code, max_code)
    #   unsigned: q = floor(clamp(x*scale + offset_out, 0, max_code) + 0.5)
    scale: float = 1.0
    offset_out: float = 0.0
    min_code: float = 0.0
    max_code: float = 0.0

    @property
    def is_float(self) -> bool:
        return self.wire_dtype is not None and self.wire_dtype.kind == "f"


def _f(name, desc, *, cplx, dtype, signed, norm=1.0, off=0.0, scale=1.0,
       off_out=0.0, mn=0.0, mx=0.0, packed_bytes=None):
    if packed_bytes is not None:
        bpf = packed_bytes
        wire = None
        items = packed_bytes
    else:
        dt = np.dtype(dtype)
        items = 2 if cplx else 1
        bpf = dt.itemsize * items
        wire = dt
    return SampleFormat(name, desc, cplx, bpf, wire, items, signed,
                        norm, off, scale, off_out, mn, mx)


# Normalizers / quantizers follow sample_convert.c exactly:
#   cs8 /128, cu8 (x-127.5)/128, cs16 /32768, sc16q11 /2048, cs24 /2^23,
#   cs32 /2^31 (double), cu32 (x-2147483647.5)/2^31 (double), cf32 pass.
#   Output: signed scale = TYPE_MAX (sc16q11: 2048), round half-away, clamp
#   [TYPE_MIN, TYPE_MAX]; unsigned scale/offset per macro; cs24 scale 2^23-1.
FORMATS: dict[str, SampleFormat] = {f.name: f for f in [
    _f("s8",  "s8 (Signed 8-bit Real)",    cplx=False, dtype=np.int8,   signed=True,
       norm=1/128.0, scale=127.0, mn=-128, mx=127),
    _f("u8",  "u8 (Unsigned 8-bit Real)",  cplx=False, dtype=np.uint8,  signed=False,
       norm=1/128.0, off=127.5, scale=127.0, off_out=127.5, mn=0, mx=255),
    _f("s16", "s16 (Signed 16-bit Real)",  cplx=False, dtype=np.int16,  signed=True,
       norm=1/32768.0, scale=32767.0, mn=-32768, mx=32767),
    _f("u16", "u16 (Unsigned 16-bit Real)", cplx=False, dtype=np.uint16, signed=False,
       norm=1/32768.0, off=32767.5, scale=32767.0, off_out=32767.5, mn=0, mx=65535),
    _f("s32", "s32 (Signed 32-bit Real)",  cplx=False, dtype=np.int32,  signed=True,
       norm=1/2147483648.0, scale=2147483647.0, mn=-2147483648, mx=2147483647),
    _f("u32", "u32 (Unsigned 32-bit Real)", cplx=False, dtype=np.uint32, signed=False,
       norm=1/2147483648.0, off=2147483647.5, scale=2147483647.0,
       off_out=2147483647.5, mn=0, mx=4294967295),
    _f("f32", "f32 (32-bit Float Real)",   cplx=False, dtype=np.float32, signed=True),
    _f("cu8", "cu8 (Unsigned 8-bit Complex)", cplx=True, dtype=np.uint8, signed=False,
       norm=1/128.0, off=127.5, scale=127.0, off_out=127.5, mn=0, mx=255),
    _f("cs8", "cs8 (Signed 8-bit Complex)", cplx=True, dtype=np.int8, signed=True,
       norm=1/128.0, scale=127.0, mn=-128, mx=127),
    _f("cu16", "cu16 (Unsigned 16-bit Complex)", cplx=True, dtype=np.uint16, signed=False,
       norm=1/32768.0, off=32767.5, scale=32767.0, off_out=32767.5, mn=0, mx=65535),
    _f("cs16", "cs16 (Signed 16-bit Complex)", cplx=True, dtype=np.int16, signed=True,
       norm=1/32768.0, scale=32767.0, mn=-32768, mx=32767),
    _f("cs24", "cs24 (Signed 24-bit Complex)", cplx=True, dtype=None, signed=True,
       norm=1/8388608.0, scale=8388607.0, mn=-8388608, mx=8388607, packed_bytes=6),
    _f("cu32", "cu32 (Unsigned 32-bit Complex)", cplx=True, dtype=np.uint32, signed=False,
       norm=1/2147483648.0, off=2147483647.5, scale=2147483647.0,
       off_out=2147483647.5, mn=0, mx=4294967295),
    _f("cs32", "cs32 (Signed 32-bit Complex)", cplx=True, dtype=np.int32, signed=True,
       norm=1/2147483648.0, scale=2147483647.0, mn=-2147483648, mx=2147483647),
    _f("cf32", "cf32 (32-bit Float Complex)", cplx=True, dtype=np.float32, signed=True),
    _f("sc16q11", "sc16q11 (16-bit Signed Complex Q4.11)", cplx=True, dtype=np.int16,
       signed=True, norm=1/2048.0, scale=2048.0, mn=-32768, mx=32767),
]}


def get_format(name: str) -> SampleFormat:
    try:
        return FORMATS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown sample format '{name}'; valid: {', '.join(FORMATS)}"
        ) from None


def complex_formats() -> list[str]:
    return [n for n, f in FORMATS.items() if f.is_complex]
