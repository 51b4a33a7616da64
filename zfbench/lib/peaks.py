"""The table of peaks the rooflines are shares of, and the bytes a call counts.

Peaks are NVIDIA's data sheet for one H100 SXM5 (80 GB HBM3) at its full
700 W limit; a run writes the card's power limit beside its numbers.  The
bytes are counted from the data the benchmark made, never read from the
program: a column's compressed bytes are the leaf buffers of its blob (what
crosses the link), its plain bytes are its source array's.
"""
from __future__ import annotations

import numpy as np

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(kind: str) -> float | None:
    """The HBM peak of a card by its ``torch.cuda.get_device_name``; None for
    a card the table lacks (its rooflines are then left out)."""
    return PEAKS.get(kind, {}).get("hbm_bytes_per_s")


def leaf_bytes(enc) -> int:
    """Bytes of a blob's leaf buffers, children included: what moves host to
    device (the lifted meta scalars are a few bytes and not counted)."""
    total = sum(int(np.asarray(b).nbytes) for b in enc.buffers.values())
    return total + sum(leaf_bytes(c) for c in enc.children.values())
