"""stagings_built.load: mean host stagings the program built per traced load
(its ``repro_torch.run.stage`` spans inside the load's ``run``: each a
page-locked allocation and a pack of a column's operands, made when the plan
meets a chunking of a column that no earlier call staged)."""
import numpy as np

from zfbench.lib.spans import durations_ns


def read(run, name):
    if run.trace is None:
        return None
    runs = durations_ns(run.trace, "run", "run")
    if not any(runs):
        return None                     # a program without spans
    return float(np.mean([len(d) for d in durations_ns(run.trace, "run", "run.stage")]))
