"""Full-CLI end-to-end for the local SDR inputs against fake drivers.

Each vendor library has an ABI-compatible stand-in under
native/fake_drivers/ that the REAL ctypes driver path loads via the
IQTOOL_<NAME>_LIB override:

* rtlsdr  — sync-read loop, bounded stream (read returns -1 at EOS);
* bladerf — sync RX (sc16q11 12-bit), bounded stream, adaptive stream
  profile configuration exercised;
* hackrf  — libusb-async RX callback from a driver thread (cs8), which
  like real hardware never ends on its own: the run is bounded by
  SIGTERM, exercising the graceful finalize path (main.c Ctrl-C analog).

* sdrplay — sdrplay_api 3.x service stand-in: PLANAR short xi/xq
  stream callbacks, a mid-stream reset (discontinuity propagation), a
  power-overload detect/correct pair (Update ack), DeviceRemoved EOS.

Run: python tools/sdr_e2e.py [--cpu] [--driver rtlsdr|bladerf|hackrf|sdrplay]
"""

import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE_DIR = os.path.join(REPO, "native", "fake_drivers")

RATE_IN = 2_048_000.0
RATE_OUT = 1_488_375.0
TONE_HZ = 100_000.0

DRIVERS = {
    "rtlsdr": ("fake_librtlsdr.c", "librtlsdr.so", "IQTOOL_RTLSDR_LIB"),
    "bladerf": ("fake_libbladerf.c", "libbladeRF.so", "IQTOOL_BLADERF_LIB"),
    "hackrf": ("fake_libhackrf.c", "libhackrf.so", "IQTOOL_HACKRF_LIB"),
    "sdrplay": ("fake_libsdrplay.c", "libsdrplay_api.so",
                "IQTOOL_SDRPLAY_API_LIB"),
}


def build_fake(driver: str, dst_dir: str) -> str:
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        raise RuntimeError("no C compiler available")
    src, soname, _ = DRIVERS[driver]
    out = os.path.join(dst_dir, soname)
    subprocess.run([cc, "-shared", "-fPIC", "-O2", "-o", out,
                    os.path.join(FAKE_DIR, src), "-lm", "-lpthread"],
                   check=True, capture_output=True, text=True)
    return out


def _env(driver: str, lib: str, n_frames: int, cpu: bool,
         env_extra: dict | None = None) -> dict:
    env = dict(os.environ)
    env[DRIVERS[driver][2]] = lib
    env["FAKE_RTLSDR_FRAMES"] = str(n_frames)
    env["FAKE_BLADERF_FRAMES"] = str(n_frames)
    env["FAKE_SDRPLAY_FRAMES"] = str(n_frames)
    if cpu:
        env["JAX_PLATFORMS"] = "cpu"
    if env_extra:
        env.update(env_extra)
    return env


def _argv(driver: str, out_path: str, extra=()) -> list:
    return [sys.executable, "-m", "iq_tool_tpu", "/dev/null", out_path,
            "-i", driver, "-o", "raw",
            "--sdr-rf-freq", "100e6", "--sdr-sample-rate", f"{RATE_IN:.0f}",
            "--output-rate", f"{RATE_OUT:.0f}",
            "--output-sample-format", "cs16",
            "--lowpass", "400000", "--force-overwrite", *extra]


def run_bounded(driver: str, n_frames: int, out_path: str, cpu: bool = False,
                extra=(), timeout: float = 600.0,
                env_extra: dict | None = None):
    """Bounded-stream drivers (rtlsdr, bladerf): run to EOS."""
    with tempfile.TemporaryDirectory() as d:
        lib = build_fake(driver, d)
        r = subprocess.run(_argv(driver, out_path, extra), cwd=REPO,
                           env=_env(driver, lib, n_frames, cpu, env_extra),
                           capture_output=True, text=True, timeout=timeout)
        return r.returncode, r.stdout, r.stderr


def run_sigterm(driver: str, out_path: str, min_bytes: int,
                cpu: bool = False, extra=(), timeout: float = 600.0):
    """Unbounded drivers (hackrf): wait for output, then SIGTERM."""
    with tempfile.TemporaryDirectory() as d:
        lib = build_fake(driver, d)
        p = subprocess.Popen(_argv(driver, out_path, extra), cwd=REPO,
                             env=_env(driver, lib, 0, cpu),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
        t0 = time.monotonic()
        try:
            while time.monotonic() - t0 < timeout:
                if (os.path.exists(out_path)
                        and os.path.getsize(out_path) >= min_bytes):
                    break
                if p.poll() is not None:
                    break
                time.sleep(0.5)
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
            out, err = p.communicate(timeout=60)
        except Exception:
            p.kill()
            raise
        return p.returncode, out, err


def check_tone(out_path: str, snr_floor: float,
               expected_frames: int | None = None, span=(20000, None)):
    raw = np.fromfile(out_path, np.int16).astype(np.float64) / 32768.0
    frames = len(raw) // 2
    if expected_frames is not None:
        assert frames == expected_frames, (frames, expected_frames)
    x = (raw[0::2] + 1j * raw[1::2])[span[0]:span[1]]
    w = np.hanning(len(x))
    p = np.abs(np.fft.fftshift(np.fft.fft(x * w))) ** 2
    f = np.fft.fftshift(np.fft.fftfreq(len(x), 1.0 / RATE_OUT))
    k = int(np.argmax(p))
    sig = p[max(0, k - 200):k + 200].sum()
    snr = 10 * np.log10(sig / (p.sum() - sig))
    assert abs(f[k] - TONE_HZ) < 200, f[k]
    assert snr > snr_floor, snr
    return frames, float(f[k]), float(snr)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--driver", choices=list(DRIVERS), default="bladerf")
    ap.add_argument("--frames", type=int, default=1 << 19)
    args = ap.parse_args()
    out = os.path.join(tempfile.gettempdir(), f"{args.driver}_e2e_out.raw")
    if args.driver == "hackrf":
        rc, so, se = run_sigterm("hackrf", out, min_bytes=1 << 21,
                                 cpu=args.cpu)
        print("rc:", rc)
        frames, peak, snr = check_tone(out, snr_floor=38.0)
    else:
        rc, so, se = run_bounded(args.driver, args.frames, out, cpu=args.cpu)
        print("rc:", rc)
        if rc != 0:
            print(se[-800:])
            return 1
        floor = 45.0 if args.driver == "rtlsdr" else 55.0
        expected = args.frames * 11907 // 16384
        if args.driver == "sdrplay":
            # mid-stream reset event: the pre/post-gap segments trim
            # independently (up to 2 frames fewer), and the reset's
            # filter-tail transient at n/3 is EXPECTED chain behavior —
            # measure the steady state on both sides of it
            n_out = os.path.getsize(out) // 4
            frames, peak, snr = check_tone(out, floor,
                                           span=(10000, n_out // 3 - 10000))
            check_tone(out, floor, span=(2 * n_out // 3, None))
            assert expected - 2 <= n_out <= expected, (n_out, expected)
            frames = n_out
        else:
            frames, peak, snr = check_tone(out, floor,
                                           expected_frames=expected)
    print(f"frames {frames}, peak {peak / 1e3:.1f} kHz, SNR {snr:.1f} dB")
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
