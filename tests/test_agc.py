"""AGC profiles: convergence, clipping ratchet, lock/hang behavior."""

import numpy as np

from iq_tool_tpu.ops import agc


def _run(profile, x_blocks, rate=1_000_000.0, target=None):
    cfg = agc.AgcConfig.make(profile, rate, target)
    st = agc.init(x_blocks[0].shape[0])
    outs = []
    for xb in x_blocks:
        y, st = agc.apply(xb, st, cfg)
        outs.append(np.asarray(y))
    return outs, st


def _tone_blocks(amp, n_blocks=8, n=16384, c=1):
    t = np.arange(n_blocks * n)
    x = (amp * np.exp(2j * np.pi * 0.01 * t)).astype(np.complex64)
    return [np.tile(x[i * n:(i + 1) * n], (c, 1)) for i in range(n_blocks)]


def test_local_converges_to_target():
    outs, st = _run("local", _tone_blocks(0.05, n_blocks=10))
    rms = np.sqrt(np.mean(np.abs(outs[-1]) ** 2))
    assert abs(rms - 0.5) < 0.05          # AGC_LOCAL_TARGET = 0.5
    assert float(np.asarray(st.gain)[0]) > 5.0


def test_dx_slower_than_local():
    _, st_dx = _run("dx", _tone_blocks(0.05, n_blocks=3))
    _, st_lo = _run("local", _tone_blocks(0.05, n_blocks=3))
    # dx bandwidth is 100x smaller: gain must have moved much less
    assert np.asarray(st_lo.gain)[0] > np.asarray(st_dx.gain)[0]


def test_digital_scan_applies_running_gain():
    outs, st = _run("digital", _tone_blocks(0.1, n_blocks=1))
    peak = np.abs(outs[0]).max()
    assert abs(peak - 0.9) < 0.02          # target/peak gain applied at once
    assert not bool(np.asarray(st.locked)[0])


def test_digital_locks_after_scan_window():
    # 2 s at 1 MHz = 2 M samples; blocks of 16384 -> lock after ~123 blocks
    blocks = _tone_blocks(0.1, n_blocks=130)
    _, st = _run("digital", blocks)
    assert bool(np.asarray(st.locked)[0])


def test_digital_clip_ratchet():
    cfg = agc.AgcConfig.make("digital", 1_000_000.0)
    st = agc.init(1)
    st = st._replace(locked=np.array([True]), gain=np.array([10.0], np.float32))
    x = (0.5 * np.ones((1, 4096))).astype(np.complex64)  # out peak 5.0 -> clip
    y, st2 = agc.apply(x, st, cfg)
    g = float(np.asarray(st2.gain)[0])
    assert abs(g - 0.99 / 0.5) < 1e-3      # 0.99/block_peak
    # the RATCHETED gain applies to this block: peak 0.5 * 0.99/0.5
    assert abs(np.abs(np.asarray(y)).max() - 0.99) < 1e-3


def test_digital_creep_after_hang():
    rate = 100_000.0
    cfg = agc.AgcConfig.make("digital", rate)
    st = agc.init(1)
    st = st._replace(locked=np.array([True]), gain=np.array([1.0], np.float32))
    weak = (0.01 * np.ones((1, 16384))).astype(np.complex64)
    gains = []
    for _ in range(40):                    # 40*16384 samples = 6.5 s > 4 s hang
        _, st = agc.apply(weak, st, cfg)
        gains.append(float(np.asarray(st.gain)[0]))
    assert gains[0] == 1.0                 # still hanging
    assert gains[-1] > 1.0                 # creeping up after hang window
    assert gains[-1] < 1.05                # slowly (1.0005/block)


def test_reset():
    st = agc.init(2)
    st = st._replace(locked=np.array([True, True]),
                     gain=np.array([5.0, 3.0], np.float32))
    r = agc.reset(st)
    assert np.all(np.asarray(r.gain) == 1.0)
    assert not np.any(np.asarray(r.locked))
