"""decode_units.load: mean decode units a load, from its ColumnExec records
(each column's decode launches; a batch of columns counts once).  A program
counter: the planner's choice of chunking and batching."""
import numpy as np


def read(run, name):
    loads = run.of("load")
    return float(np.mean([c["decode_units"] for c in loads])) if loads else None
