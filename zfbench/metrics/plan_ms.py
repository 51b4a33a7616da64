"""plan_ms.load: mean duration of the program's span ``repro_torch.plan``
(all of ``StreamingExecutor.plan``) per traced load, in ms: the host's time
planning a load, from the program's own span on the profiler's clock."""
import numpy as np

from zfbench.lib.spans import durations_ns


def read(run, name):
    if run.trace is None:
        return None
    vals = [sum(d) for d in durations_ns(run.trace, "plan", "plan") if d]
    return float(np.mean(vals)) / 1e6 if vals else None
