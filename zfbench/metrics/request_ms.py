"""request_ms.p<N>: the N-th percentile (NumPy's linear interpolation) over the
window's completed requests of a request's latency, in ms: from its
*scheduled* arrival (so a late submit shows) to its completion, when its last
column was seen decoded on the device (``ServeRequest.submitted_at +
latency_s``).  A request not completed within the grace is ``failed``, not a
latency."""
import numpy as np


def read(run, name):
    lat = [(c["t1"] - c["t0"]) * 1e3 for c in run.of("request") if c["t1"] is not None]
    if not lat:
        return None
    return float(np.percentile(lat, float(name.rsplit(".p", 1)[1])))
