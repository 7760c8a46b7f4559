"""Checks that need the GPU (marker ``gpu``; they skip elsewhere).

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import pytest

import chip_smoke

CONFIGS = list(chip_smoke.bench_configs(1, 4096))


@pytest.mark.gpu
@pytest.mark.parametrize("name", CONFIGS)
def test_chain_on_gpu_matches_cpu_backend(gpu_device, name):
    """Each bench config at 8 x 16384 on the card: tone SNR and parity
    with the CPU backend of the same process (chip_smoke phase 3)."""
    res = chip_smoke.phase_batched(channels=8, block=16384, steps=2,
                                   names=[name], device=gpu_device)
    assert set(res) == {name}
