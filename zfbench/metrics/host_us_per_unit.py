"""host_us_per_unit.load: the host's time per decode unit of a load, in us:
per traced load, the duration of the program's span ``repro_torch.run`` less
its ``repro_torch.run.sync`` children (the host waiting for the device),
divided by the load's decode units (its record's ``decode_units``); the mean
over the traced loads."""
import numpy as np

from zfbench.lib.spans import durations_ns


def read(run, name):
    if run.trace is None:
        return None
    runs = durations_ns(run.trace, "run", "run")
    syncs = durations_ns(run.trace, "run", "run.sync")
    loads = [c for c in run.of("load") if c.get("traced")]
    if len(runs) != len(loads):
        return None
    vals = [(sum(r) - sum(s)) / 1e3 / c["decode_units"]
            for r, s, c in zip(runs, syncs, loads) if r and c["decode_units"]]
    return float(np.mean(vals)) if vals else None
