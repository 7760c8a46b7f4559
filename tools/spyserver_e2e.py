"""Live SpyServer end-to-end: protocol-faithful fake server on a real
socket -> `-i spyserver-client` CLI chain on the device -> raw file checks.

Run: python tools/spyserver_e2e.py
"""
import subprocess, sys, tempfile, threading
import numpy as np
import os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import tests.test_spyserver as ts

OUT = os.path.join(tempfile.gettempdir(), "spy_out.raw")


class ToneServer(ts.FakeSpyServer):
    def _serve(self):
        import socket, struct
        from iq_tool_tpu.modules.input_spyserver import (
            _CMD_HEADER, _DEVICE_INFO, CMD_SET_SETTING,
            MSG_CLIENT_SYNC, MSG_DEVICE_INFO, MSG_UINT8_IQ,
            SETTING_STREAMING_ENABLED)
        c, _ = self._srv.accept()
        try:
            cmd, size = _CMD_HEADER.unpack(self._recv_all(c, _CMD_HEADER.size))
            self.hello_payload = self._recv_all(c, size)
            di = _DEVICE_INFO.pack(3, 42, self.max_rate, 0, self.dec_count,
                                   10, 29, 24_000_000, 1_700_000_000, 8,
                                   self.min_dec, self.forced_fmt)
            self._send_msg(c, MSG_DEVICE_INFO, di)
            sync = struct.pack("<9I", 1, 0, 100_000_000, 100_000_000,
                               0, 0, 0xFFFFFFFF, 0, 0)
            self._send_msg(c, MSG_CLIENT_SYNC, sync)
            while True:
                cmd, size = _CMD_HEADER.unpack(self._recv_all(c, _CMD_HEADER.size))
                body = self._recv_all(c, size)
                if cmd != CMD_SET_SETTING:
                    continue
                setting, value = struct.unpack("<2I", body)
                self.settings[setting] = value
                if setting == SETTING_STREAMING_ENABLED and value == 1:
                    break
            fs = 2_048_000.0
            t = np.arange(self.n_frames) / fs
            x = 0.45 * np.exp(2j * np.pi * 100e3 * t)
            iq = np.empty(self.n_frames * 2, np.uint8)
            iq[0::2] = np.floor(x.real * 128 + 127.5 + 0.5).clip(0, 255)
            iq[1::2] = np.floor(x.imag * 128 + 127.5 + 0.5).clip(0, 255)
            payload = iq.tobytes()
            for i in range(0, len(payload), 8192):
                self._send_msg(c, MSG_UINT8_IQ, payload[i:i + 8192])
            import socket as sk
            c.shutdown(sk.SHUT_WR)
            self._recv_all(c, 1)
        except Exception:
            pass
        finally:
            c.close()
            self._srv.close()


srv = ToneServer(max_rate=4_096_000, min_dec=1, dec_count=4,
                 n_frames=1 << 19)
r = subprocess.run(
    [sys.executable, "-m", "iq_tool_tpu", "/dev/null", OUT,
     "-i", "spyserver-client", "-o", "raw",
     "--spyserver-client-host", "127.0.0.1",
     "--spyserver-client-port", str(srv.port),
     "--spyserver-client-format", "cu8",
     "--sdr-rf-freq", "100e6", "--sdr-sample-rate", "2048000",
     "--output-rate", "1488375", "--output-sample-format", "cs16",
     "--lowpass", "400000", "--no-watchdog", "--force-overwrite"],
    cwd=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."),
    capture_output=True, text=True, timeout=540)
print("rc:", r.returncode)
if r.returncode:
    print(r.stderr[-800:])
    sys.exit(1)
raw = np.fromfile(OUT, np.int16).astype(np.float64) / 32768.0
x = (raw[0::2] + 1j * raw[1::2])[20000:]
w = np.hanning(len(x))
p = np.abs(np.fft.fftshift(np.fft.fft(x * w))) ** 2
f = np.fft.fftshift(np.fft.fftfreq(len(x), 1 / 1_488_375.0))
k = int(np.argmax(p))
sig = p[max(0, k - 200):k + 200].sum(); noise = p.sum() - sig
print(f"frames {len(raw)//2}, peak {f[k]/1e3:.1f} kHz, "
      f"SNR {10*np.log10(sig/noise):.1f} dB")
