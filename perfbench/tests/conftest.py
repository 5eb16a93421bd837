import os
import sys

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
for p in (os.path.join(_ROOT, "src"), _ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card; skipped (by its fixture) without one")
