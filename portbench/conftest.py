"""The benchmark's own tests.  Those marked ``card`` run a cell on a CUDA
device and skip without one (decided inside the test, never at import)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: runs on a CUDA device; skips without one")
