"""The benchmark's own tests (`python -m pytest dasbench/tests`), apart
from the repository's suite. Tests marked `card` need an NVIDIA GPU and
skip elsewhere; whether there is one is decided inside a fixture."""
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (runs on the chip only)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture
def small_batch(monkeypatch):
    """A fixed chunk size: no autotune probe on the CPU."""
    monkeypatch.setenv("REPRO_BENCH_BATCH", "64")


# A fault model in the configurations' form (`inputs.fault_plans`): no
# cell uses one yet, since no public fault setting for a DSSoC is in the
# repository; the tests hold the generator's plans and the harness's plan
# path to the port with this one (the repository's stress set).
STRESS_FAULTS = {
    "permanent_failures": 2, "transients": 4, "horizon_us": 200.0,
    "repair_after": [0.2, 1.0],
    "even_scenarios": {"max_retries": 2, "deadline_us": 6.0},
    "odd_scenarios": {"max_retries": 0, "deadline_us": None}}
