"""query_roofline.query: the traced queries' compressed bytes at the HBM
peak over their device time, in %.

Bytes: the compressed leaf buffers of the columns each query reads (its
reference's ``COLUMNS``), counted once a query from the benchmark's data.
Time: the summed duration of every device operation in the traced slice but
the host-to-device copies: decode kernels, the fused query kernel, memsets,
device-to-device and device-to-host copies."""
from zfbench.lib import peaks, registry
from zfbench.lib.trace import H2D


def read(run, name):
    tr = run.trace
    qs = [c for c in run.of("query") if c.get("traced")]
    if tr is None or not qs:
        return None
    ns = sum(d.end - d.start for d in tr.device if d.kind != H2D)
    peak = peaks.hbm_bytes_per_s(run.device_kind)
    if ns <= 0 or peak is None:
        return None
    comp = run.counted["compressed"]
    cols = {}
    nbytes = 0
    for c in qs:
        q = c["query"]
        if q not in cols:
            cols[q] = sum(comp[n] for n in registry.reference_query(q).COLUMNS)
        nbytes += cols[q]
    return 100.0 * nbytes / peak / (ns / 1e9)
