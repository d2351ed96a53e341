import sys

import pytest

try:                                    # property tests prefer the real thing
    import hypothesis                   # noqa: F401
except ImportError:                     # container without hypothesis: stub it
    import _hypothesis_stub as _stub

    sys.modules["hypothesis"] = _stub
    sys.modules["hypothesis.strategies"] = _stub.strategies


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where CUDA is absent")
