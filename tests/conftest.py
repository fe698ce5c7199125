import os
import sys

# Tests run on the single real CPU device (the 512-device flag lives ONLY in
# repro.launch.dryrun, which tests exercise via subprocess).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)

from repro.analysis import sanitize as _sanitize  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "card: runs on a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def _avec_sanitize():
    """When AVEC_SANITIZE=1, assert per-test that (a) every BufferLease
    acquired during the test was released (allowing a GC grace for
    pin-until-collected views) and (b) the tracked locks recorded no
    lock-order cycle.  Off by default: plain primitives, zero overhead."""
    if not _sanitize.enabled():
        yield
        return
    tracker = _sanitize.global_lease_tracker()
    recorder = _sanitize.global_lock_recorder()
    baseline = tracker.live_count()
    yield
    # teardown-ordering slack: servers/runtimes the test closed may release
    # their last leases from daemon threads just after the test body returns
    tracker.assert_quiescent(grace_s=2.0, baseline=baseline)
    recorder.assert_no_cycles()
