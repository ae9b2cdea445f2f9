import dataclasses
import os
import sys

# tests see the real (1-device) CPU topology — only the dry-run forces 512.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import numpy as np
import pytest

from repro.configs import get_smoke
from repro.models import transformer as tfm


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")


@pytest.fixture
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture
def nprng():
    return np.random.default_rng(0)


# One tiny model shared by every suite (registry / scheduler / prefix-cache /
# system): session-scoped so params init once, with the DMS knobs every suite
# needs (short delay window, CPU-scale CR ramp for the retrofit test).
@pytest.fixture(scope="session")
def tiny_arch():
    arch = get_smoke("qwen-r1-1.5b")
    return dataclasses.replace(
        arch, dms=dataclasses.replace(arch.dms, window=4, target_cr=4.0,
                                      steps_per_cr_unit=5))


@pytest.fixture(scope="session")
def tiny_params(tiny_arch):
    return tfm.init_model(jax.random.PRNGKey(0), tiny_arch)
