import os
import sys

# tests must see exactly 1 device (the dry-run sets 512 in its OWN
# process); guard against accidental inheritance.
os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

# hypothesis is an optional dev dependency (requirements-dev.txt).  When
# absent, fall back to a deterministic stub so the suite still collects
# and runs instead of aborting at import time.
try:
    from hypothesis import settings, HealthCheck  # noqa: E402
except ModuleNotFoundError:
    import _hypothesis_stub  # noqa: E402

    _hypothesis_stub.install()
    from hypothesis import settings, HealthCheck  # noqa: E402

settings.register_profile(
    "repro",
    max_examples=15,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow,
                           HealthCheck.data_too_large],
)
settings.load_profile("repro")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card; skipped (by its fixture) without one")
