"""Arithmetic of the reference, and of its control in a lower precision.

``rounder("float64")`` widens every value to float64, the reference's
precision.  ``rounder("bfloat16")`` rounds every value to the nearest
bfloat16 (ties to even), kept in float32: the configuration states float32,
and bfloat16 is the step below it.  The product or difference of two
bfloat16 values is exact in float32, so rounding each result of float32
arithmetic once gives bfloat16 arithmetic.
"""
from __future__ import annotations

import numpy as np


def round_bfloat16(x: np.ndarray) -> np.ndarray:
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def rounder(precision: str):
    if precision == "float64":
        return lambda x: np.asarray(x, np.float64)
    if precision == "bfloat16":
        return round_bfloat16
    raise ValueError(f"no such precision {precision!r}")
