"""query_chunks.query: mean ``QueryExec.n_chunks``, the row chunks the
query's chunk search chose (a program counter)."""
import numpy as np


def read(run, name):
    qs = run.of("query")
    return float(np.mean([c["n_chunks"] for c in qs])) if qs else None
