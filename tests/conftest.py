"""Shared fixtures.  NOTE: no XLA_FLAGS here by design -- smoke tests and benches
must see the single real CPU device; only launch/dryrun.py forces 512 devices."""
import os

import numpy as np
import pytest


def pytest_configure(config):
    """Opt-in hang watchdog for threaded-executor tests (the async dispatch
    engine runs worker threads; a deadlock would otherwise hang CI silently
    until the job-level timeout with no stacks).  REPRO_TEST_TIMEOUT_S=<secs>
    arms faulthandler to dump EVERY thread's traceback and hard-exit once the
    whole pytest run exceeds the budget -- the dump names the blocked thread,
    which a plain timeout kill never would."""
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere")
    secs = os.environ.get("REPRO_TEST_TIMEOUT_S")
    if secs:
        import faulthandler

        faulthandler.dump_traceback_later(float(secs), exit=True)


@pytest.fixture
def rng():
    return np.random.default_rng(0)
