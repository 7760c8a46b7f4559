"""chip_smoke.py's phases rehearsed on the CPU backend at a small size.

The script's main refuses a host without a GPU; these call the phase
functions directly so wrong paths, arguments and checks surface here."""

import jax
import pytest

import chip_smoke

CONFIGS = list(chip_smoke.bench_configs(1, 4096))


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err


def test_phase_cli(tmp_path):
    res = chip_smoke.phase_cli(str(tmp_path), frames=1 << 17)
    assert res["snr_db"] >= 60.0


@pytest.mark.parametrize("name", CONFIGS)
def test_phase_batched(name):
    cpu = jax.devices("cpu")[0]
    res = chip_smoke.phase_batched(channels=2, block=16384, steps=2,
                                   ref_device=cpu, names=[name])
    assert set(res) == {name}


def test_phase_engines():
    res = chip_smoke.phase_engines(channels=2, block=16384, kernel=False)
    assert len(res) == 5
    assert all(ms > 0 for t in res.values() for ms in t.values())


def test_phase_multi(tmp_path):
    res = chip_smoke.phase_multi(str(tmp_path), frames=1 << 16)
    assert len(res) == 2
