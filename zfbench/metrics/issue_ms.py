"""issue_ms.load: mean ``StreamingExecutor.last_issue_s`` a load, in ms: the
host's seconds issuing the run's copies (a span the program keeps)."""
import numpy as np


def read(run, name):
    vals = [c["issue_s"] for c in run.of("load") if c["issue_s"] is not None]
    return float(np.mean(vals)) * 1e3 if vals else None
