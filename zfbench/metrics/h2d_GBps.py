"""h2d_GBps.<op>: bytes of the traced host-to-device copies over their summed
duration on the device, in GB/s (1e9 bytes): the link's rate while it
copies."""
from zfbench.lib.trace import H2D


def read(run, name):
    if run.trace is None:
        return None
    ops = run.trace.ops(H2D)
    ns = sum(d.end - d.start for d in ops)
    nbytes = sum(d.nbytes for d in ops)
    if ns <= 0 or nbytes <= 0:
        return None
    return nbytes / ns
