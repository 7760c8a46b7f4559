"""Independent numpy oracle implementing the reference's numeric contracts.

This is the golden model the C binary would provide if liquid-dsp /
libsndfile were installed in this image (they are not — SURVEY.md section 4
item 1 fallback).  It is written directly from the C contracts in
sample_convert.c and standard DSP definitions, deliberately NOT sharing any
code with iq_tool_tpu, so agreement is meaningful.
"""

import numpy as np

_NORM = {
    "cs8": 1 / 128.0, "cu8": 1 / 128.0, "cs16": 1 / 32768.0,
    "cu16": 1 / 32768.0, "sc16q11": 1 / 2048.0, "cs24": 1 / 8388608.0,
    "cs32": 1 / 2147483648.0, "cu32": 1 / 2147483648.0,
}
_OFF = {"cu8": 127.5, "cu16": 32767.5, "cu32": 2147483647.5}
def to_cf32(raw: np.ndarray, fmt: str, gain: float = 1.0) -> np.ndarray:
    """sample_convert.c:127-202 in numpy."""
    if fmt == "cf32":
        f = raw.astype(np.float32)
        return (f[0::2] + 1j * f[1::2]).astype(np.complex64) * np.float32(gain)
    if fmt == "cs24":
        b = raw.reshape(-1, 6).astype(np.int64)
        iv = ((b[:, 0] << 8) | (b[:, 1] << 16) | (b[:, 2] << 24)).astype(np.int32) >> 8
        qv = ((b[:, 3] << 8) | (b[:, 4] << 16) | (b[:, 5] << 24)).astype(np.int32) >> 8
        n = np.float32(_NORM[fmt])
        g = np.float32(gain)
        return ((iv.astype(np.float32) * n * g)
                + 1j * (qv.astype(np.float32) * n * g)).astype(np.complex64)
    if fmt in ("cs32", "cu32"):
        # reference uses double intermediates here
        f = raw.astype(np.float64)
        if fmt == "cu32":
            f = f - _OFF[fmt]
        f = f * _NORM[fmt] * gain
        out = f[0::2].astype(np.float32) + 1j * f[1::2].astype(np.float32)
        return out.astype(np.complex64)
    f = raw.astype(np.float32)
    if fmt in _OFF:
        f = f - np.float32(_OFF[fmt])
    f = (f * np.float32(_NORM[fmt])) * np.float32(gain)
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


_SIGNED_OUT = {
    "cs8": (127.0, -128, 127, np.int8),
    "cs16": (32767.0, -32768, 32767, np.int16),
    "sc16q11": (2048.0, -32768, 32767, np.int16),
    "cs24": (8388607.0, -8388608, 8388607, None),
    "cs32": (2147483647.0, -2147483648, 2147483647, np.int32),
}
_UNSIGNED_OUT = {
    "cu8": (127.0, 127.5, 255, np.uint8),
    "cu16": (32767.0, 32767.5, 65535, np.uint16),
    "cu32": (2147483647.0, 2147483647.5, 4294967295, np.uint32),
}


def from_cf32(x: np.ndarray, fmt: str) -> np.ndarray:
    """sample_convert.c:40-73, 213-303 in numpy."""
    if fmt == "cf32":
        out = np.empty(x.size * 2, np.float32)
        out[0::2], out[1::2] = x.real, x.imag
        return out
    pairs = np.empty(x.size * 2, np.float32)
    pairs[0::2], pairs[1::2] = x.real.astype(np.float32), x.imag.astype(np.float32)
    if fmt in _SIGNED_OUT:
        scale, mn, mx, dt = _SIGNED_OUT[fmt]
        use64 = fmt in ("cs32",)
        v = pairs.astype(np.float64) * scale if use64 else pairs * np.float32(scale)
        v = np.where(v > 0, v + (0.5 if use64 else np.float32(0.5)),
                     v - (0.5 if use64 else np.float32(0.5)))
        v = np.trunc(v)
        v = np.clip(v.astype(np.float64), mn, mx)
        codes = v.astype(np.int64)
        if fmt == "cs24":
            c = codes.astype(np.int64) & 0xFFFFFF
            out = np.empty((x.size * 2, 3), np.uint8)
            out[:, 0] = c & 0xFF
            out[:, 1] = (c >> 8) & 0xFF
            out[:, 2] = (c >> 16) & 0xFF
            return out.reshape(-1)
        return codes.astype(dt)
    scale, off, mx, dt = _UNSIGNED_OUT[fmt]
    use64 = fmt == "cu32"
    if use64:
        v = pairs.astype(np.float64) * scale + off
    else:
        v = pairs * np.float32(scale) + np.float32(off)
    v = np.clip(v.astype(np.float64), 0.0, mx)
    return np.floor(v + 0.5).astype(np.int64).clip(0, mx).astype(dt)


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """SNR of `test` against `ref` in dB (higher = closer)."""
    ref = np.asarray(ref, np.complex128)
    test = np.asarray(test, np.complex128)
    err = ref - test
    p_sig = np.mean(np.abs(ref) ** 2)
    p_err = np.mean(np.abs(err) ** 2)
    if p_err == 0:
        return np.inf
    return float(10 * np.log10(p_sig / p_err))


def tone_snr(z: np.ndarray, rate: float, half_width: int = 200):
    """(peak frequency Hz, tone SNR dB) of a complex tone record: Hann
    window, the +-half_width bins around the spectral peak are signal,
    every other bin is noise, spurs and images."""
    z = np.asarray(z, np.complex128)
    p = np.abs(np.fft.fftshift(np.fft.fft(z * np.hanning(len(z))))) ** 2
    f = np.fft.fftshift(np.fft.fftfreq(len(z), 1.0 / rate))
    k = int(np.argmax(p))
    sig = p[max(0, k - half_width):k + half_width + 1].sum()
    return float(f[k]), float(10 * np.log10(sig / max(p.sum() - sig, 1e-30)))


def parity_snr(got: np.ndarray, want: np.ndarray) -> float:
    """SNR (dB) of one quantized record against another (inf if equal)."""
    diff = got.astype(np.float64) - want.astype(np.float64)
    if not diff.any():
        return float("inf")
    return float(10 * np.log10((want.astype(np.float64) ** 2).mean()
                               / (diff ** 2).mean()))


def assert_parity(got: np.ndarray, want: np.ndarray, tag="") -> float:
    """Quantized-output parity between two runs of the same chain: more
    than 60 dB SNR (the chain contract) plus a hard code cap.  The DC IIR
    and the AGC gain loop amplify legitimate f32 association deltas, so
    exact equality is not the contract.  The cap scales with output
    hotness: the AGC normalizes toward full scale, so the same ~2e-3
    single-sample relative bound is ~128 codes there.  Returns the SNR
    (inf when identical)."""
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    snr = parity_snr(got, want)
    assert snr > 60.0, (tag, snr)
    diff = got.astype(np.float64) - want.astype(np.float64)
    cap = 4e-3 * max(np.abs(want).max(), 8192)
    assert np.abs(diff).max() <= cap, (tag, np.abs(diff).max(), cap)
    assert (np.abs(diff) > cap / 4).mean() < 1e-3, (
        tag, (np.abs(diff) > cap / 4).mean())
    return snr
