"""wave_requests.serve: mean requests a wave composes (``len(WaveReport.rids)``)
over the window's waves that served no profiled request: how far the
planner's shared waves batch across requests."""
import numpy as np


def read(run, name):
    waves = [w for w in run.of("wave") if not w["traced"]]
    return float(np.mean([w["requests"] for w in waves])) if waves else None
