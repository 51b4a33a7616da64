"""wave_ms.serve: mean ``WaveReport.wall_s`` of the window's waves that served
no profiled request, in ms: a wave's host wall time from registration to its
last column decoded (registration, planning, the executor's run)."""
import numpy as np


def read(run, name):
    waves = [w for w in run.of("wave") if not w["traced"]]
    return float(np.mean([w["wall_s"] for w in waves])) * 1e3 if waves else None
