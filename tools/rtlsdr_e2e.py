"""Full-CLI rtlsdr end-to-end against a fake driver library.

Compiles native/fake_drivers/fake_librtlsdr.c into a librtlsdr.so, points
the REAL RtlSdrInput ctypes path at it via IQTOOL_RTLSDR_LIB, and runs the
actual CLI — `-i rtlsdr --sdr-buffered` so the synthetic tone flows
through the sync-read reader thread, IQPK packet framing, the magic-scan
reader, the chain, and the raw sink (reference path:
input_rtlsdr.c:295-372 -> sdr_packet_serializer.c -> pipeline).

Checks: exact output frame accounting (floor(frames_in * P/Q)) and the
tone's frequency/SNR at the output rate.

Run: python tools/rtlsdr_e2e.py [--cpu] [--realtime]
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE_SRC = os.path.join(REPO, "native", "fake_drivers", "fake_librtlsdr.c")

RATE_IN = 2_048_000.0
RATE_OUT = 1_488_375.0
TONE_HZ = 100_000.0          # FAKE_HZ in fake_librtlsdr.c


def build_fake_lib(dst_dir: str) -> str:
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        raise RuntimeError("no C compiler available")
    out = os.path.join(dst_dir, "librtlsdr.so")
    subprocess.run([cc, "-shared", "-fPIC", "-O2", "-o", out, FAKE_SRC,
                    "-lm"], check=True, capture_output=True, text=True)
    return out


def run_e2e(n_frames: int, out_path: str, cpu: bool = False,
            buffered: bool = True, timeout: float = 600.0):
    """Returns (returncode, stdout, stderr)."""
    with tempfile.TemporaryDirectory() as d:
        lib = build_fake_lib(d)
        env = dict(os.environ)
        env["IQTOOL_RTLSDR_LIB"] = lib
        env["FAKE_RTLSDR_FRAMES"] = str(n_frames)
        if cpu:
            env["JAX_PLATFORMS"] = "cpu"
        argv = [sys.executable, "-m", "iq_tool_tpu",
                "/dev/null", out_path,
                "-i", "rtlsdr", "-o", "raw",
                "--sdr-rf-freq", "100e6", "--sdr-sample-rate",
                f"{RATE_IN:.0f}",
                "--output-rate", f"{RATE_OUT:.0f}",
                "--output-sample-format", "cs16",
                "--lowpass", "400000", "--force-overwrite"]
        if buffered:
            argv.append("--sdr-buffered")
        r = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=timeout)
        return r.returncode, r.stdout, r.stderr


def check_output(out_path: str, n_frames: int):
    """Returns (frames_out, expected_frames, peak_hz, snr_db)."""
    raw = np.fromfile(out_path, np.int16).astype(np.float64) / 32768.0
    frames = len(raw) // 2
    expected = n_frames * 11907 // 16384
    x = (raw[0::2] + 1j * raw[1::2])[20000:]
    w = np.hanning(len(x))
    p = np.abs(np.fft.fftshift(np.fft.fft(x * w))) ** 2
    f = np.fft.fftshift(np.fft.fftfreq(len(x), 1.0 / RATE_OUT))
    k = int(np.argmax(p))
    sig = p[max(0, k - 200):k + 200].sum()
    noise = p.sum() - sig
    return frames, expected, float(f[k]), float(10 * np.log10(sig / noise))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    ap.add_argument("--realtime", action="store_true",
                    help="raw-ring realtime path instead of --sdr-buffered")
    ap.add_argument("--frames", type=int, default=1 << 19)
    args = ap.parse_args()
    out_path = os.path.join(tempfile.gettempdir(), "rtlsdr_e2e_out.raw")
    rc, so, se = run_e2e(args.frames, out_path, cpu=args.cpu,
                         buffered=not args.realtime)
    print("rc:", rc)
    if rc:
        print(se[-800:])
        return 1
    frames, expected, peak_hz, snr = check_output(out_path, args.frames)
    print(f"frames {frames} (expected {expected}), "
          f"peak {peak_hz / 1e3:.1f} kHz, SNR {snr:.1f} dB")
    # SNR bar: the source is 8-bit cu8 at 0.45 FS, whose quantization
    # floor is ~48 dB — the chain must preserve it, not beat it
    ok = frames == expected and abs(peak_hz - TONE_HZ) < 200 and snr > 45.0
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
