"""TPC-H Q6 (forecasting revenue change) in NumPy, over the columns as the
benchmark generated them.

    select sum(extendedprice * discount) from lineitem
    where shipdate >= :d and shipdate < :d + 1 year
      and discount between 0.05 and 0.07 and quantity < 24

The dates are 8766 and 9131 (1994-01-01 and 1995-01-01 in days since
1970-01-01).  The discount's bounds are compared in the column's own
arithmetic (float32, or the control's lower precision): the decimals 0.05
and 0.07 stored as float32 are inside the range, as SQL compares a REAL
column with its literals.  Lanes are the revenue and the count, each a (1,)
row.
"""
from __future__ import annotations

import numpy as np

from zfbench.reference.precision import rounder

COLUMNS = ("L_EXTENDEDPRICE", "L_DISCOUNT", "L_QUANTITY", "L_SHIPDATE")
N_SEGMENTS = 1


def lanes(cols: dict, precision: str = "float64") -> np.ndarray:
    """(2, 1): the revenue (per-row product in ``precision``, summed in
    float64) and the count of selected rows."""
    r = rounder(precision)
    d = r(cols["L_DISCOUNT"].astype(np.float32))
    lo, hi = r(np.float32(0.05)), r(np.float32(0.07))
    sel = ((cols["L_SHIPDATE"] >= 8766) & (cols["L_SHIPDATE"] < 9131)
           & (d >= lo) & (d <= hi) & (cols["L_QUANTITY"] < 24))
    rev = r(r(cols["L_EXTENDEDPRICE"][sel].astype(np.float32)) * d[sel])
    return np.array([[np.asarray(rev, np.float64).sum()], [float(sel.sum())]])
