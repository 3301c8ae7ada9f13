import warnings

warnings.filterwarnings("ignore", category=DeprecationWarning)

# NOTE: do NOT set XLA_FLAGS/device-count here — smoke tests and benches
# must see the real single CPU device; only launch/dryrun.py forces 512.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (runs on the chip only)")
