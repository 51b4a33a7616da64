"""TPC-H Q1 (pricing summary report) in NumPy, over the columns as the
benchmark generated them.

    select l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice),
           sum(l_extendedprice * (1 - l_discount)),
           sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
           avg(l_quantity), avg(l_extendedprice), avg(l_discount), count(*)
    from lineitem where l_shipdate <= date '1998-12-01' - interval '90' day
    group by l_returnflag, l_linestatus

with the specification's validation parameter (DELTA 90): the shipdate
bound is 1998-09-02, 10471 days since 1970-01-01.  The averages are the sums
over the count, so the lanes are the five sums (quantity, extendedprice,
discounted price, charge, discount) and the count, in that order, each an
(8,) row over the segments.  A group's segment is 2 * f + s: f is 0, 2, 3
for the flags 'A', 'R', 'N', and s is 0, 1 for the statuses 'F', 'O'.
"""
from __future__ import annotations

import numpy as np

from zfbench.reference.precision import rounder

COLUMNS = ("L_RETURNFLAG", "L_LINESTATUS", "L_QUANTITY", "L_EXTENDEDPRICE",
           "L_DISCOUNT", "L_TAX", "L_SHIPDATE")
N_SEGMENTS = 8
SHIPDATE_MAX = 10471
FLAG_SEGMENT = {ord("A"): 0, ord("R"): 2, ord("N"): 3}


def segments(flag: np.ndarray, status: np.ndarray) -> np.ndarray:
    """Each row's segment from its flag character and status code."""
    table = np.full(256, N_SEGMENTS, np.int64)     # another flag falls outside every segment
    for ch, f in FLAG_SEGMENT.items():
        table[ch] = f
    return table[flag.astype(np.int64)] * 2 + status.astype(np.int64)


def lanes(cols: dict, precision: str = "float64") -> np.ndarray:
    """(6, 8): per-row arithmetic in ``precision``, each segment's sum in
    float64; the count exact."""
    r = rounder(precision)
    sel = cols["L_SHIPDATE"] <= SHIPDATE_MAX
    key = segments(cols["L_RETURNFLAG"][sel], cols["L_LINESTATUS"][sel])
    qty, price, disc, tax = (r(cols[c][sel].astype(np.float32))
                             for c in ("L_QUANTITY", "L_EXTENDEDPRICE", "L_DISCOUNT", "L_TAX"))
    disc_price = r(price * r(1 - disc))
    charge = r(disc_price * r(1 + tax))
    width = 2 * N_SEGMENTS + 2
    out = [np.bincount(key, weights=np.asarray(v, np.float64), minlength=width)[:N_SEGMENTS]
           for v in (qty, price, disc_price, charge, disc)]
    out.append(np.bincount(key, minlength=width)[:N_SEGMENTS].astype(np.float64))
    return np.stack(out)
