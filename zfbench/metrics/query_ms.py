"""query_ms.p<N>: the N-th percentile (NumPy's linear interpolation) of one
``run_query`` call's wall time over every query of the window, all queries
together."""
import numpy as np


def read(run, name):
    qs = run.of("query")
    if not qs:
        return None
    q = float(name.rsplit(".p", 1)[1])
    return float(np.percentile([(c["t1"] - c["t0"]) * 1e3 for c in qs], q))
