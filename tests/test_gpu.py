"""chip_smoke.py's family checks as tests that need an NVIDIA GPU.

Run on the card with
    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py
The CPU backend stays enabled: some checks compare with it. Everywhere
else the tests skip; the fixture decides, never the import.
"""
import jax
import pytest

import chip_smoke


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(chip_smoke.FAMILY_CHECKS))
def test_family_matches_reference_on_gpu(gpu, name):
    rows, _ = chip_smoke.FAMILY_CHECKS[name]()
    for label, err, tol in rows:
        assert err < tol, (label, err, tol)
