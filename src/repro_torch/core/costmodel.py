"""Chunk-size formulas shared by the streaming executor and (later) the planner.

Only the pure formulas of the reference's ``core/costmodel.py`` are here: how
many rows of a buffer fit one transfer chunk, how many output elements or
whole groups one decode chunk covers, and how a group span's launch is padded.
Each has one home so that a planned chunk count equals the executed one.  The
column profiles, the cost model and the link topology come with the planner.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

# output-pad granularity for uneven group spans: body spans pad to one shared
# shape, so one span program serves every body span of a structure
GROUP_PAD_ELEMS = 128


def rows_per_chunk(shape0: int, nbytes: int, chunk_bytes: int) -> int:
    """Rows of an axis-0-split buffer that fit in one transfer chunk."""
    return max(1, chunk_bytes // max(1, nbytes // max(1, shape0)))


def aligned_chunk_elems(chunk_bytes: int, per_elem_bytes: float, align: int) -> int:
    """Output elements per decode chunk: about ``chunk_bytes`` of compressed
    tile bytes, rounded down to the boundary alignment (at least one)."""
    elems = int(chunk_bytes / max(per_elem_bytes, 1e-9)) // align * align
    return max(align, elems)


def groups_per_chunk(chunk_bytes: int, bytes_per_group: float, align: int) -> int:
    """Whole groups per decode span: about ``chunk_bytes`` of streamed group
    bytes, rounded down to the group-boundary alignment (at least one)."""
    g = int(chunk_bytes / max(bytes_per_group, 1e-9)) // align * align
    return max(align, g)


def pad_group_elems(elems: int) -> int:
    return max(GROUP_PAD_ELEMS, -(-int(elems) // GROUP_PAD_ELEMS) * GROUP_PAD_ELEMS)


def group_bytes_per_group(layout, ops: Mapping[str, np.ndarray]) -> float:
    """Streamed (sliced-leaf) compressed bytes per group of a
    ``GroupChunkLayout``: axis-0 leaves give ``num/den`` rows per group, axis-1
    leaves (the rANS stripe) one column per group."""
    total = 0.0
    for nm, spec in layout.sliced.items():
        arr = np.asarray(ops[nm])
        if layout.axes.get(nm, 0) == 1:
            total += float(arr.shape[0]) * arr.dtype.itemsize
        else:
            num = int(np.asarray(ops[spec.num_op])[0]) if spec.num_op else spec.num
            row = arr.dtype.itemsize * (int(np.prod(arr.shape[1:])) if arr.ndim > 1 else 1)
            total += num / spec.den * row
    return total
