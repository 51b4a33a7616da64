"""decode_roofline.load: the loads' bytes at the HBM peak over the device
time of the decode, in %.

Bytes are counted once each from the benchmark's data, whatever implements
the decode: every column's compressed leaf buffers read and its plain bytes
written, times the traced loads.  Time is the summed duration of every
kernel, memset and device-to-device copy in the traced slice (the link's
host-to-device copies are ``h2d_GBps``'s)."""
from zfbench.lib import peaks
from zfbench.lib.trace import D2D, KERNEL, MEMSET


def read(run, name):
    tr = run.trace
    loads = [c for c in run.of("load") if c.get("traced")]
    if tr is None or not loads:
        return None
    ns = sum(d.end - d.start for d in tr.ops(KERNEL, MEMSET, D2D))
    if ns <= 0:
        return None
    peak = peaks.hbm_bytes_per_s(run.device_kind)
    if peak is None:
        return None
    per_load = sum(run.counted["compressed"].values()) + sum(run.counted["plain"].values())
    return 100.0 * per_load * len(loads) / peak / (ns / 1e9)
