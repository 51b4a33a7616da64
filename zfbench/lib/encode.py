"""The deployment's offline step: each column encoded with its plan by the
port's public ``repro_torch.core.plan.encode``, one column a task, each
column handed over as soon as the generator draws it.

The tasks run on a pool of threads (the encoders spend most of their time in
NumPy, which releases the interpreter lock), joined before this returns.
Threads beat worker processes here: no interpreter to start and import
PyTorch into, and no column to pickle across.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor


def default_workers() -> int:
    return max(1, min(8, len(os.sched_getaffinity(0))))


def encode_columns(columns, plans: dict) -> tuple[dict, dict, dict]:
    """``columns`` yields (name, array) in order; returns the plain columns,
    their ``Encoded`` blobs (both by name) and the seconds spent generating
    and in all."""
    from repro_torch.core.plan import encode

    plain, futures = {}, {}
    t0 = time.perf_counter()
    gen_s = 0.0
    with ThreadPoolExecutor(max_workers=default_workers(),
                            thread_name_prefix="zfbench-encode") as pool:
        t = time.perf_counter()
        for name, arr in columns:
            gen_s += time.perf_counter() - t
            plain[name] = arr
            futures[name] = pool.submit(encode, plans[name], arr)
            t = time.perf_counter()
        encoded = {name: f.result() for name, f in futures.items()}
    return plain, encoded, {"generate": gen_s, "generate_encode": time.perf_counter() - t0}
