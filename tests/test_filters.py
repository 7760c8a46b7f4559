"""Streaming FIR/FFT filter engine vs scipy.signal.lfilter, plus design checks."""

import numpy as np
import pytest
import scipy.signal as sig

from iq_tool_tpu.ops import fir_design, filters


def _run_stream(f: filters.StreamingFilter, x: np.ndarray, block: int) -> np.ndarray:
    state = f.init(1)
    outs = []
    for i in range(0, len(x), block):
        y, state = f(x[None, i:i + block], state)
        outs.append(np.asarray(y)[0])
    return np.concatenate(outs)


@pytest.mark.parametrize("method,taps_n", [("fir", 31), ("fir", 1), ("fft", 31),
                                           ("fft", 257), ("fft", 1024)])
def test_matches_lfilter_real_taps(rng, method, taps_n):
    taps = rng.standard_normal(taps_n)
    taps /= np.abs(taps).sum()
    x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)).astype(np.complex64)
    f = filters.StreamingFilter(taps.astype(np.complex64), method=method)
    block = max(f.block, 2048)
    y = _run_stream(f, x, block)
    want = sig.lfilter(taps, [1.0], x)
    np.testing.assert_allclose(y, want, atol=5e-4)


def test_matches_lfilter_complex_taps(rng):
    taps = (rng.standard_normal(99) + 1j * rng.standard_normal(99)).astype(np.complex64)
    taps /= np.abs(taps).sum()
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    f = filters.StreamingFilter(taps, method="fft")
    y = _run_stream(f, x, max(f.block, 2048))
    want = sig.lfilter(taps, [1.0], x)
    np.testing.assert_allclose(y, want, atol=5e-4)


def test_fir_fft_agree(rng):
    taps = rng.standard_normal(63).astype(np.complex64)
    taps /= np.abs(taps).sum()
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    y1 = _run_stream(filters.StreamingFilter(taps, "fir"), x, 2048)
    f2 = filters.StreamingFilter(taps, "fft")
    y2 = _run_stream(f2, x, max(f2.block, 2048))
    np.testing.assert_allclose(y1, y2, atol=5e-4)


def test_fft_banded_exec_matches_dft_exec(rng):
    """The fft method's banded-matmul execution engine (<=2048 taps) is
    exact linear convolution — identical within float tolerance to the
    FFT overlap-save engine on the same filter/state geometry."""
    taps = (rng.standard_normal(301) + 1j * rng.standard_normal(301)) \
        .astype(np.complex64)
    taps /= np.abs(taps).sum()
    x = (rng.standard_normal(16384)
         + 1j * rng.standard_normal(16384)).astype(np.complex64)
    f = filters.StreamingFilter(taps, "fft")
    assert f._exec_banded
    y_banded = _run_stream(f, x, max(f.block, 2048))
    f._exec_banded = False          # force the FFT overlap-save engine
    y_dft = _run_stream(f, x, max(f.block, 2048))
    np.testing.assert_allclose(y_banded, y_dft, atol=5e-4)


def test_fft_dft_engine_large_taps(rng):
    """> 2048 taps stays on the FFT engine and still matches lfilter."""
    taps = rng.standard_normal(2501).astype(np.complex64)
    taps /= np.abs(taps).sum()
    x = (rng.standard_normal(16384)
         + 1j * rng.standard_normal(16384)).astype(np.complex64)
    f = filters.StreamingFilter(taps, "fft")
    assert not f._exec_banded
    y = _run_stream(f, x, max(f.block, 4096))
    want = sig.lfilter(taps, [1.0], x)
    np.testing.assert_allclose(y, want, atol=1e-3)


def test_streaming_split_invariance(rng):
    """Different block splits give identical output (overlap-save carry)."""
    taps = rng.standard_normal(127).astype(np.complex64)
    taps /= np.abs(taps).sum()
    x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)).astype(np.complex64)
    f = filters.StreamingFilter(taps, "fft")
    b = f.block
    y1 = _run_stream(f, x, b)
    y2 = _run_stream(f, x, 4 * b)
    np.testing.assert_allclose(y1, y2, atol=1e-4)


# ------------------------------ design ---------------------------------------

def _freq_response(taps, n=4096):
    return np.fft.fftshift(np.fft.fft(taps, n))


def test_lowpass_design():
    d = fir_design.design_chain(
        [fir_design.FilterRequest("lowpass", 100_000.0)], sample_rate=1_000_000.0)
    h = _freq_response(d.taps)
    f = np.linspace(-0.5, 0.5, len(h), endpoint=False)
    dc = np.abs(h[len(h) // 2])
    assert abs(dc - 1.0) < 0.01                        # unity DC gain
    stop = np.abs(h[np.abs(f) > 0.145])                # beyond cutoff+transition
    assert 20 * np.log10(stop.max() + 1e-12) < -55.0   # 60 dB design
    passband = np.abs(h[np.abs(f) < 0.08])
    assert np.all(np.abs(20 * np.log10(passband)) < 0.2)


def test_highpass_design():
    d = fir_design.design_chain(
        [fir_design.FilterRequest("highpass", 100_000.0)], sample_rate=1_000_000.0)
    h = _freq_response(d.taps)
    f = np.linspace(-0.5, 0.5, len(h), endpoint=False)
    dc_region = np.abs(h[np.abs(f) < 0.055])
    assert 20 * np.log10(dc_region.max() + 1e-12) < -55.0
    hi = np.abs(h[np.abs(f) > 0.15])
    assert np.max(np.abs(20 * np.log10(hi))) < 0.5     # peak-normalized passband


def test_passband_offcenter_is_complex():
    d = fir_design.design_chain(
        [fir_design.FilterRequest("pass-range", 200_000.0, 50_000.0)],
        sample_rate=1_000_000.0)
    assert d.is_complex
    h = _freq_response(d.taps)
    f = np.linspace(-0.5, 0.5, len(h), endpoint=False)
    # passband at +0.2, stopband at -0.2 (asymmetric!)
    pos = np.abs(h[np.abs(f - 0.2) < 0.015]).max()
    neg = np.abs(h[np.abs(f + 0.2) < 0.015]).max()
    assert pos > 0.9
    assert 20 * np.log10(neg / pos + 1e-12) < -55.0


def test_stop_range_notch():
    d = fir_design.design_chain(
        [fir_design.FilterRequest("stop-range", 0.0, 100_000.0)],
        sample_rate=1_000_000.0)
    h = _freq_response(d.taps)
    f = np.linspace(-0.5, 0.5, len(h), endpoint=False)
    notch = np.abs(h[np.abs(f) < 0.02])
    assert 20 * np.log10(notch.max() + 1e-12) < -50.0
    outside = np.abs(h[np.abs(f) > 0.1])
    assert outside.max() > 0.9


def test_chained_filters_convolve():
    reqs = [fir_design.FilterRequest("lowpass", 150_000.0),
            fir_design.FilterRequest("highpass", 20_000.0)]
    d = fir_design.design_chain(reqs, sample_rate=1_000_000.0)
    d1 = fir_design.design_chain([reqs[0]], 1_000_000.0)
    d2 = fir_design.design_chain([reqs[1]], 1_000_000.0)
    assert len(d.taps) == len(d1.taps) + len(d2.taps) - 1


def test_min_taps_and_odd():
    d = fir_design.design_chain(
        [fir_design.FilterRequest("lowpass", 400_000.0)], sample_rate=1_000_000.0)
    assert len(d.taps) >= 21 and len(d.taps) % 2 == 1


def test_choose_fft_block():
    # filter.c:317-336: next pow2 >= taps-1, doubled if < 2*taps
    # auto floor is FFT_MIN_BLOCK for batched device FFTs
    assert fir_design.choose_fft_block(21) == 2048
    assert fir_design.choose_fft_block(129) == 2048
    assert fir_design.choose_fft_block(1024) == 2048
    assert fir_design.choose_fft_block(3000) == 8192
    assert fir_design.choose_fft_block(2175) == 8192
    assert fir_design.choose_fft_block(100, user_fft_size=512) == 256
    with pytest.raises(ValueError):
        fir_design.choose_fft_block(1000, user_fft_size=512)


def test_non_multiple_block_length(rng):
    """Overlap-save must handle N not divisible by the FFT block (e.g. the
    resampler's 11907-sample outputs)."""
    taps = rng.standard_normal(257).astype(np.complex64)
    taps /= np.abs(taps).sum()
    f = filters.StreamingFilter(taps, "fft")
    x = (rng.standard_normal(11907 * 2) + 1j * rng.standard_normal(11907 * 2)).astype(np.complex64)
    state = f.init(1)
    outs = []
    for i in range(0, len(x), 11907):
        y, state = f(x[None, i:i + 11907], state)
        outs.append(np.asarray(y)[0])
    got = np.concatenate(outs)
    want = sig.lfilter(taps, [1.0], x)
    np.testing.assert_allclose(got, want, atol=5e-4)


# (taps, user FFT size, block lengths of the stream): the config #4
# notch (2175 taps, block 8192), framings that are and are not multiples
# of the FFT block (the resampler's 11907-sample outputs), and a forced
# FFT size whose block is barely above the tap count
OVERLAP_SAVE_CASES = [
    (2175, None, [16384, 16384]),
    (2175, None, [11907, 11907, 11907]),
    (2175, None, [8192 + 777, 3 * 8192 // 2]),
    (2049, None, [10000, 9999]),
    (2501, None, [16384 + 5]),
    (5000, 16384, [2 * 8192 + 1000, 8192]),
    (3000, None, [8192, 24576 + 3]),
    (1025, 4096, [2048 * 3 + 1, 2048]),
]


@pytest.mark.parametrize("taps_n,user_fft,blocks", OVERLAP_SAVE_CASES)
def test_overlap_save_matches_convolution(rng, taps_n, user_fft, blocks):
    """The jnp.fft overlap-save engine over a stream split into the given
    blocks equals numpy's direct linear convolution of the whole stream
    (complex taps, two channels, carry threaded between blocks)."""
    taps = (rng.standard_normal(taps_n)
            + 1j * rng.standard_normal(taps_n)).astype(np.complex64)
    taps /= np.abs(taps).sum()
    f = filters.StreamingFilter(taps, "fft", user_fft)
    f._exec_banded = False
    assert all(n >= f.block for n in blocks)
    n = sum(blocks)
    x = (rng.standard_normal((2, n))
         + 1j * rng.standard_normal((2, n))).astype(np.complex64)
    state = f.init(2)
    outs, s = [], 0
    for b in blocks:
        y, state = f(x[:, s:s + b], state)
        outs.append(np.asarray(y))
        s += b
    got = np.concatenate(outs, axis=-1)
    for c in range(2):
        want = np.convolve(x[c].astype(np.complex128),
                           taps.astype(np.complex128))[:n]
        np.testing.assert_allclose(got[c], want, atol=2e-5 * np.sqrt(taps_n))
