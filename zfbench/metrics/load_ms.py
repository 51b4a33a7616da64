"""load_ms.p<N>: the N-th percentile (NumPy's linear interpolation) over the
window's loads of one call's wall time, from its start to the device's
synchronize."""
import numpy as np


def read(run, name):
    loads = run.of("load")
    if not loads:
        return None
    q = float(name.rsplit(".p", 1)[1])
    return float(np.percentile([(c["t1"] - c["t0"]) * 1e3 for c in loads], q))
