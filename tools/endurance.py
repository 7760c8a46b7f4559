"""Long-stream stability soak (the reference's long-duration proof-point
analog, main.c:19-25).

Modes (composable; default runs all three):

* straight soak — generate N seconds of cs16 tone, stream it through the
  flagship chain with periodic checkpoints, verify exact frame
  accounting and the tone's SNR in the final window (no drift / state
  decay);
* --kill-resume — SIGKILL the CLI mid-stream (hard crash, no cleanup),
  re-run with --resume against the surviving checkpoint, and assert the
  recovered output is BYTE-IDENTICAL to an uninterrupted run (the
  checkpoint's crash-consistent-cut + sink-truncate contract,
  pipeline/checkpoint.py + runtime.py);
* --iqpk-soak — run the fake-rtlsdr CLI in --sdr-buffered mode with
  IQTOOL_FAULT_IQPK_EVERY corrupting every K-th IQPK header, and verify
  the magic-scan resync recovers (CLI exits 0, resyncs logged, output
  tone intact — sdr_packet_serializer.c:111-204 behavior).

    python tools/endurance.py [--seconds 600] [--kill-resume]
                              [--iqpk-soak] [--all]
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

FS_IN, FS_OUT = 2_048_000, 1_488_375.0
REPO = os.path.join(os.path.dirname(__file__), "..")


def make_tone(path: str, seconds: int) -> int:
    n = FS_IN * seconds
    # stream to disk in 1-second chunks (a 10-minute tone is ~5 GB)
    with open(path, "wb") as f:
        for s in range(seconds):
            t = (np.arange(FS_IN, dtype=np.float64) + s * FS_IN) / FS_IN
            x = 0.5 * np.exp(2j * np.pi * 100e3 * t)
            iq = np.empty(2 * FS_IN, np.int16)
            iq[0::2] = np.round(x.real * 32768).clip(-32768, 32767)
            iq[1::2] = np.round(x.imag * 32768).clip(-32768, 32767)
            f.write(iq.tobytes())
    return n


def cli_args(src: str, dst: str, ckpt: str | None, resume: bool = False):
    a = [sys.executable, "-m", "iq_tool_tpu", src, dst,
         "--input", "raw-file", "--output", "raw",
         "--raw-file-input-rate", str(FS_IN),
         "--raw-file-input-sample-format", "cs16",
         "--output-rate", str(FS_OUT), "--output-sample-format", "cs16",
         "--lowpass", "400000", "--dc-block",
         "--block-size", "262144", "--pipeline-depth", "8",
         "--force-overwrite"]
    if ckpt:
        a += ["--checkpoint", ckpt, "--checkpoint-interval", "5"]
    if resume:
        a += ["--resume"]
    return a


def check_tone(dst: str, n_in: int, label: str) -> bool:
    raw = np.fromfile(dst, np.int16)
    expect = n_in * 11907 // 16384
    if len(raw) != 2 * expect:
        print(f"FAIL {label}: {len(raw) // 2} frames out, expected {expect}")
        return False
    tail = raw[-2 * (1 << 20):].astype(np.float64) / 32768.0
    z = tail[0::2] + 1j * tail[1::2]
    if not np.isfinite(z).all():
        print(f"FAIL {label}: non-finite samples in the final window")
        return False
    w = np.hanning(len(z))
    p = np.abs(np.fft.fftshift(np.fft.fft(z * w))) ** 2
    f = np.fft.fftshift(np.fft.fftfreq(len(z), 1 / FS_OUT))
    k = int(np.argmax(p))
    sig = p[max(0, k - 200):k + 200].sum()
    snr = 10 * np.log10(sig / max(p.sum() - sig, 1e-30))
    ok = abs(f[k] - 100e3) < 50 and snr > 60
    print(f"{'PASS' if ok else 'FAIL'} {label}: {expect} frames exact, "
          f"final-window peak {f[k] / 1e3:.2f} kHz, SNR {snr:.1f} dB")
    return ok


def soak(tmp: str, src: str, n_in: int) -> bool:
    dst = os.path.join(tmp, "out.raw")
    t0 = time.monotonic()
    r = subprocess.run(cli_args(src, dst, os.path.join(tmp, "state.ckpt")),
                       cwd=REPO)
    wall = time.monotonic() - t0
    if r.returncode:
        print("FAIL soak: cli rc", r.returncode)
        return False
    print(f"soak wall {wall:.0f}s ({n_in / wall / 1e6:.1f} Msps through "
          "the single-channel CLI incl. host file I/O)")
    return check_tone(dst, n_in, "soak")


def kill_resume(tmp: str, src: str, n_in: int) -> bool:
    """SIGKILL mid-stream, --resume, byte-compare vs the straight run."""
    ref = os.path.join(tmp, "ref.raw")
    r = subprocess.run(cli_args(src, ref, None), cwd=REPO)
    if r.returncode:
        print("FAIL kill-resume: reference run rc", r.returncode)
        return False
    ref_bytes = os.path.getsize(ref)

    dst = os.path.join(tmp, "kr.raw")
    ckpt = os.path.join(tmp, "kr.ckpt")
    p = subprocess.Popen(cli_args(src, dst, ckpt), cwd=REPO)
    # wait until the run is well underway (past >=1 checkpoint), then
    # kill -9: a hard crash with in-flight pipeline state
    deadline = time.monotonic() + 600
    while time.monotonic() < deadline:
        time.sleep(1.0)
        if p.poll() is not None:
            print("FAIL kill-resume: run finished before the kill "
                  "(stream too short for the soak)")
            return False
        if (os.path.isfile(ckpt)
                and os.path.isfile(dst)
                and os.path.getsize(dst) > ref_bytes * 0.3):
            break
    os.kill(p.pid, signal.SIGKILL)
    p.wait()
    killed_at = os.path.getsize(dst) if os.path.isfile(dst) else 0
    r = subprocess.run(cli_args(src, dst, ckpt, resume=True), cwd=REPO)
    if r.returncode:
        print("FAIL kill-resume: resume rc", r.returncode)
        return False
    got = open(dst, "rb").read()
    want = open(ref, "rb").read()
    ok = got == want
    print(f"{'PASS' if ok else 'FAIL'} kill-resume: killed at "
          f"{killed_at / 1e6:.1f} MB, resumed to {len(got) / 1e6:.1f} MB, "
          f"byte-identical to the uninterrupted run: {ok}")
    if not ok and len(got) == len(want):
        first = int(np.flatnonzero(np.frombuffer(got, np.uint8)
                                   != np.frombuffer(want, np.uint8))[0])
        print(f"  first differing byte at offset {first}")
    return ok


def iqpk_soak(tmp: str, every: int = 37) -> bool:
    """Fake-rtlsdr CLI in --sdr-buffered mode with every K-th IQPK
    header corrupted: the reader's magic scan must recover and the CLI
    must finish cleanly with the tone intact."""
    from tools.rtlsdr_e2e import build_fake_lib

    lib = build_fake_lib(tmp)
    n_frames = 1 << 22
    dst = os.path.join(tmp, "iqpk.raw")
    env = dict(os.environ)
    env.update(IQTOOL_RTLSDR_LIB=lib,
               FAKE_RTLSDR_FRAMES=str(n_frames),
               IQTOOL_FAULT_IQPK_EVERY=str(every))
    r = subprocess.run(
        [sys.executable, "-m", "iq_tool_tpu", "/dev/null", dst,
         "-i", "rtlsdr", "-o", "raw",
         "--sdr-rf-freq", "100e6", "--sdr-sample-rate", f"{FS_IN}",
         "--output-rate", f"{FS_OUT:.0f}",
         "--output-sample-format", "cs16",
         "--lowpass", "400000", "--sdr-buffered", "--force-overwrite"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    if r.returncode:
        print("FAIL iqpk-soak: cli rc", r.returncode, r.stderr[-400:])
        return False
    resynced = "recovered corrupted framing" in (r.stderr or "")
    raw = np.fromfile(dst, np.int16).astype(np.float64) / 32768.0
    z = (raw[0::2] + 1j * raw[1::2])[1 << 18:]
    w = np.hanning(len(z))
    p = np.abs(np.fft.fftshift(np.fft.fft(z * w))) ** 2
    sig = p[max(0, int(np.argmax(p)) - 200):int(np.argmax(p)) + 200].sum()
    snr = 10 * np.log10(sig / max(p.sum() - sig, 1e-30))
    # corrupted packets DROP samples (discontinuities smear some energy),
    # so the bar is recovery + a usable tone, not the clean-stream SNR
    ok = resynced and len(raw) > 0 and snr > 20
    print(f"{'PASS' if ok else 'FAIL'} iqpk-soak: resync logged={resynced}, "
          f"{len(raw) // 2} frames out, post-corruption tone SNR "
          f"{snr:.1f} dB")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=int, default=600)
    ap.add_argument("--kill-resume", action="store_true")
    ap.add_argument("--iqpk-soak", action="store_true")
    ap.add_argument("--all", action="store_true")
    opts = ap.parse_args()
    run_soak = opts.all or not (opts.kill_resume or opts.iqpk_soak)
    ok = True
    with tempfile.TemporaryDirectory(prefix="iq_endurance_") as tmp:
        if run_soak or opts.kill_resume or opts.all:
            src = os.path.join(tmp, "tone.raw")
            n_in = make_tone(src, opts.seconds)
        if run_soak:
            ok &= soak(tmp, src, n_in)
        if opts.kill_resume or opts.all:
            ok &= kill_resume(tmp, src, n_in)
        if opts.iqpk_soak or opts.all:
            ok &= iqpk_soak(tmp)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
