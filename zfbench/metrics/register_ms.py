"""register_ms.serve: mean ``WaveReport.register_s`` of the window's waves that
served no profiled request, in ms: the host's time registering a wave's
columns (programs, cost-model profiles, chunk schedules, pinned staging and
its pack) before it plans."""
import numpy as np


def read(run, name):
    waves = [w for w in run.of("wave") if not w["traced"]]
    return float(np.mean([w["register_s"] for w in waves])) * 1e3 if waves else None
