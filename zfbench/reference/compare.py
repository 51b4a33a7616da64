"""The comparison that decides ``correct``, its limits, and its control.

The reference works from the plain columns the benchmark generated, never
from anything the program made.  A load's answer is every decoded column: it
has to equal its source bit for bit.  A query's answer is every lane of its
accumulator (the aggregates and the count) and of its finalized result: the
count lanes have to equal the NumPy count exactly, the float lanes have to
lie within ``LIMITS["max_rel_err"]`` of the float64 reference, relative to
the reference's value (a lane the reference reads as 0 and the program does
not is off by 1.0, all of itself).

The control puts the reference in the program's place, computed one step
below the precision the configuration states: float32 columns through
bfloat16 for a load, each row's arithmetic in bfloat16 for a query.  It has
to come out not correct; ``zfbench/control.py`` reads it on the chip at a
cell's size, and ``test_zfbench_control.py`` at a small one.
"""
from __future__ import annotations

import numpy as np

from zfbench.lib import registry
from zfbench.reference.precision import round_bfloat16

# Each limit lies between the largest reading of sound runs of the program
# and the smallest reading of the control; PERF.md gives both readings.
LIMITS = {
    "missing_columns": 0,          # a load's answer lacks a column, or has one of another shape
    "mismatched_elements": 0,      # decoded elements that differ from the source, bitwise
    "missing_answers": 0,          # compared calls without an answer
    "count_lane_mismatches": 0,    # query count lanes that differ from NumPy's count
    "max_rel_err": 2e-5,           # float lanes against the float64 reference
    "lost_requests": 0,            # served requests never completed, or whose wave raised
}


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def compare_load(plain: dict, answers: list[dict]) -> dict:
    """Each answer ({column: array}) against the source columns, bitwise."""
    missing = mismatched = 0
    for ans in answers:
        for name, src in plain.items():
            got = ans.get(name)
            if got is None or got.shape != src.shape or got.dtype != src.dtype:
                missing += 1
                mismatched += int(src.size)
                continue
            mismatched += int(np.count_nonzero(_bits(got) != _bits(src)))
    return {"missing_columns": missing, "mismatched_elements": mismatched,
            "missing_answers": 0 if answers else 1}


def reference_lanes(plain: dict, queries, precision: str = "float64") -> dict:
    return {q: registry.reference_query(q).lanes(plain, precision) for q in queries}


def compare_queries(plain: dict, answers: list[tuple], lanes: dict | None = None) -> dict:
    """Each answer (query, accumulator, result) against the reference's lanes.

    The accumulator holds every lane (aggregates, then the count), lane-major
    over the segments; the result holds the aggregate lanes, and the count
    lane where the query keeps it."""
    if lanes is None:
        lanes = reference_lanes(plain, sorted({a[0] for a in answers}))
    counts = 0
    rel = 0.0
    for q, acc, result in answers:
        ref = lanes[q]
        n_lanes, n_seg = ref.shape
        acc = np.asarray(acc, np.float64).reshape(-1)
        res = np.asarray(result, np.float64).reshape(-1)
        if acc.size != ref.size or res.size not in (ref.size, ref.size - n_seg):
            counts += ref.size
            rel = max(rel, 1.0)
            continue
        for got in (acc.reshape(n_lanes, n_seg), res.reshape(-1, n_seg)):
            k = got.shape[0]
            if k == n_lanes:
                counts += int(np.count_nonzero(got[-1] != ref[-1]))
            want = ref[:min(k, n_lanes - 1)]
            val = got[:want.shape[0]]
            zero = want == 0
            if np.any(val[zero] != 0):       # off by all of itself
                rel = max(rel, 1.0)
            if np.any(~zero):
                err = np.abs(val[~zero] - want[~zero]) / np.abs(want[~zero])
                rel = max(rel, float(err.max()))
    return {"count_lane_mismatches": counts, "max_rel_err": rel,
            "missing_answers": 0 if answers else 1}


def readings(plain: dict, answers: list, loads: bool, queries: list) -> dict:
    """Every number compared for a run's kept answers: a load's ({column:
    array}) and a query's ((query, accumulator, result))."""
    out: dict = {}
    if loads:
        out.update(compare_load(plain, [a for a in answers if isinstance(a, dict)]))
    if queries:
        got = compare_queries(plain, [a for a in answers if isinstance(a, tuple)],
                              reference_lanes(plain, queries))
        for k, v in got.items():
            out[k] = max(out.get(k, 0), v)
    return out


def within(readings: dict) -> bool:
    return bool(readings) and all(readings[k] <= LIMITS[k] for k in readings)


# ---------------------------------------------------------------- the control

def control_load_answer(plain: dict) -> dict:
    """The reference in the program's place, its float32 columns carried in
    bfloat16."""
    return {n: (round_bfloat16(a) if a.dtype == np.float32 else a.copy())
            for n, a in plain.items()}


def control_query_answers(plain: dict, queries) -> list[tuple]:
    """The reference in the program's place, each row's arithmetic in
    bfloat16: (query, lanes, finalized lanes) as the program answers."""
    low = reference_lanes(plain, queries, "bfloat16")
    return [(q, low[q], low[q]) for q in queries]
