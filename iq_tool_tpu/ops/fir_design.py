"""FIR filter design (setup-time, numpy).

Re-implements the design semantics of src/filter.c:138-336 without
liquid-dsp:

* per-stage Kaiser-windowed sinc (liquid_firdes_kaiser equivalent), taps
  estimated from the transition width and attenuation
  (estimate_req_filter_len), forced odd, min 21 (filter.c:180-195);
* highpass / stopband via spectral inversion (filter.c:94-99);
* off-center passband via heterodyne of the real lowpass prototype with a
  complex exponential -> asymmetric complex taps (filter.c:205-218);
* chained requests combine by convolving tap sets (filter.c:249-255);
* normalization by peak |H(f)| over 2048 frequency points when any stage
  is non-lowpass or the final taps are complex, else by DC gain
  (filter.c:272-299).

Tap-count and Kaiser-window formulas follow the standard Kaiser design
equations (the same family liquid-dsp uses); exact tap counts may differ
by a few taps from liquid, which is inside the 60 dB SNR contract.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from iq_tool_tpu import constants as C

FilterType = Literal["lowpass", "highpass", "pass-range", "stop-range"]


@dataclasses.dataclass(frozen=True)
class FilterRequest:
    """One user filter request (CLI: --lowpass/--highpass/--pass-range/...).

    freq1_hz: cutoff (low/highpass) or center (pass/stop-range)
    freq2_hz: width for pass/stop-range
    """
    type: FilterType
    freq1_hz: float
    freq2_hz: float = 0.0


def kaiser_beta(atten_db: float) -> float:
    a = float(atten_db)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def estimate_taps(transition_norm: float, atten_db: float) -> int:
    """Kaiser tap-count estimate: N ~= (A - 7.95) / (14.26 * df)."""
    df = max(float(transition_norm), 1e-9)
    n = int(np.ceil((float(atten_db) - 7.95) / (14.26 * df)))
    return max(n, 1)


def kaiser_lowpass(num_taps: int, fc_norm: float, atten_db: float,
                   mu: float = 0.0) -> np.ndarray:
    """liquid_firdes_kaiser equivalent: windowed sinc, unity-ish DC gain.

    fc_norm: cutoff in cycles/sample (0 .. 0.5).
    """
    n = int(num_taps)
    beta = kaiser_beta(atten_db)
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0 + mu
    h = 2.0 * fc_norm * np.sinc(2.0 * fc_norm * t)
    w = np.kaiser(n, beta)
    return (h * w).astype(np.float64)


def spectral_invert(taps: np.ndarray) -> np.ndarray:
    """filter.c:94-99: negate, +1 at center tap."""
    out = -taps.copy()
    out[(len(out) - 1) // 2] += 1.0
    return out


def design_request(req: FilterRequest, sample_rate: float, atten_db: float,
                   num_taps: int | None = None,
                   transition_hz: float | None = None) -> np.ndarray:
    """Design one stage's taps (complex128).  filter.c:169-246."""
    fs = float(sample_rate)
    if num_taps is None:
        if transition_hz is None:
            ref = (req.freq1_hz if req.type in ("lowpass", "highpass")
                   else req.freq2_hz)
            transition_hz = abs(ref) * 0.25  # DEFAULT_FILTER_TRANSITION_FACTOR
        transition_hz = max(transition_hz, 1.0)
        n = estimate_taps(transition_hz / fs, atten_db)
        if n % 2 == 0:
            n += 1
        n = max(n, C.FILTER_MIN_TAPS)
    else:
        # the reference forces odd lengths (filter.c:188-190): spectral
        # inversion needs an exact center tap
        n = int(num_taps)
        if n % 2 == 0:
            n += 1

    if req.type in ("pass-range", "stop-range") and abs(req.freq1_hz) > 1e-9:
        # off-center band: heterodyne a real LPF prototype to the center
        # (filter.c:205-218).  The reference only heterodynes pass-range —
        # its stopband silently ignores the band center (filter.c:238-241);
        # here the inversion is applied to the shifted prototype so
        # off-center notches actually notch the requested band.
        half_bw = (req.freq2_hz / 2.0) / fs
        proto = kaiser_lowpass(n, half_bw, atten_db)
        fc = req.freq1_hz / fs
        # Phase ramp referenced to the CENTER tap (the reference starts its
        # NCO at tap 0, filter.c:211-218 — same magnitude response, but the
        # centered ramp keeps H(fc) real-positive, which spectral inversion
        # below requires).
        ph = 2.0 * np.pi * fc * (np.arange(n) - (n - 1) / 2.0)
        taps = proto * np.exp(1j * ph)
        if req.type == "stop-range":
            taps = -taps
            taps[(n - 1) // 2] += 1.0
        return taps

    if req.type == "lowpass":
        taps = kaiser_lowpass(n, req.freq1_hz / fs, atten_db)
    elif req.type == "highpass":
        taps = spectral_invert(kaiser_lowpass(n, req.freq1_hz / fs, atten_db))
    elif req.type == "pass-range":   # centered at 0
        taps = kaiser_lowpass(n, (req.freq2_hz / 2.0) / fs, atten_db)
    elif req.type == "stop-range":
        # filter.c:238-241: LPF at width/2, spectrally inverted (centered notch)
        taps = spectral_invert(kaiser_lowpass(n, (req.freq2_hz / 2.0) / fs, atten_db))
    else:
        raise ValueError(f"unknown filter type {req.type!r}")
    return taps.astype(np.complex128)


@dataclasses.dataclass(frozen=True)
class DesignedFilter:
    taps: np.ndarray          # complex64 master taps
    is_complex: bool          # any asymmetric stage
    normalize_by_peak: bool


def design_chain(requests: list[FilterRequest], sample_rate: float,
                 atten_db: float = C.RESAMPLER_ATTENUATION_DB,
                 num_taps: int | None = None,
                 transition_hz: float | None = None) -> DesignedFilter | None:
    """Combine up to FILTER_MAX_CHAIN requests into master taps."""
    if not requests:
        return None
    if len(requests) > C.FILTER_MAX_CHAIN:
        raise ValueError(f"at most {C.FILTER_MAX_CHAIN} chained filters")

    master = np.array([1.0 + 0j])
    normalize_by_peak = False
    is_complex = False
    for req in requests:
        if req.type != "lowpass":
            normalize_by_peak = True
        if req.type in ("pass-range", "stop-range") and abs(req.freq1_hz) > 1e-9:
            is_complex = True
        taps = design_request(req, sample_rate, atten_db, num_taps, transition_hz)
        master = np.convolve(master, taps)

    if normalize_by_peak or is_complex:
        # peak |H| over a 2048-point frequency grid (filter.c:272-290)
        k = np.arange(C.FILTER_NORM_FREQ_POINTS)
        freqs = k / C.FILTER_NORM_FREQ_POINTS - 0.5
        ph = np.exp(-2j * np.pi * np.outer(freqs, np.arange(len(master))))
        mags = np.abs(ph @ master)
        peak = mags.max()
        if peak > 1e-9:
            master = master / peak
    else:
        dc = np.real(master).sum()
        if abs(dc) > 1e-9:
            master = master / dc

    return DesignedFilter(taps=master.astype(np.complex64),
                          is_complex=is_complex,
                          normalize_by_peak=normalize_by_peak)


def max_filter_freq_hz(requests: list[FilterRequest]) -> float:
    """Highest frequency any stage needs (filter.c:57-76)."""
    mx = 0.0
    for req in requests:
        if req.type in ("lowpass", "highpass"):
            cur = abs(req.freq1_hz)
        else:
            cur = abs(req.freq1_hz) + req.freq2_hz / 2.0
        mx = max(mx, cur)
    return mx


def choose_fft_block(num_taps: int, user_fft_size: int | None = None) -> int:
    """Overlap-save block size (outputs per FFT), filter.c:317-336.

    Returns the 'block' n; the FFT length is 2n (fftfilt convention).
    """
    if user_fft_size is not None and user_fft_size > 0:
        block = user_fft_size // 2
        if block < num_taps - 1:
            raise ValueError(
                f"--filter-fft-size {user_fft_size} too small for {num_taps} taps; "
                f"need at least {(num_taps - 1) * 2}")
        return block
    block = 1
    while block < num_taps - 1:
        block *= 2
    if block < num_taps * 2:
        block *= 2
    # the reference sizes for CPU cache locality (filter.c:317-336); a
    # batched device FFT favours larger blocks, so the auto size has a
    # floor; --filter-fft-size still overrides.
    return max(block, C.FFT_MIN_BLOCK)
