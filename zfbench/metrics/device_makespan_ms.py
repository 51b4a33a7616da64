"""device_makespan_ms.<op>: mean makespan the program times with CUDA events,
in ms: ``StreamingExecutor.last_makespan_s`` of a load (``.load``),
``QueryExec.makespan_s`` of a query (``.query``)."""
import numpy as np


def read(run, name):
    op = name.rsplit(".", 1)[1]
    vals = [c["makespan_s"] for c in run.of(op) if c.get("makespan_s") is not None]
    return float(np.mean(vals)) * 1e3 if vals else None
