"""Kernel launch geometry: the paper's <L, S, C> configuration vector (§4), read
the paper's own GPU way.

    L  -> main-loop iterations of each thread,
    S  -> threads per block,
    C  -> contiguous elements each thread produces per iteration.

One block covers L*S*C output elements; grid = ceil(N / (L*S*C)).

The reference package re-derives these for TPU VMEM tiles and picks a chip's
"native" geometry with an analytic cost model and autotuner; those come over in
a later slice.  Until then ``native_config`` returns one fixed geometry per
pattern for the card.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The paper's <L, S, C> kernel configuration vector (GPU interpretation)."""

    L: int  # main-loop iterations per thread
    S: int  # threads per block
    C: int  # contiguous elements per thread per iteration

    def __post_init__(self):
        if min(self.L, self.S, self.C) < 1 or self.S > 1024:
            raise ValueError(f"invalid geometry {self}")

    @property
    def tile(self) -> int:
        """Elements processed per block (the paper's L*S*C tile size)."""
        return self.L * self.S * self.C

    def grid(self, n: int) -> int:
        return max(1, math.ceil(n / self.tile))

    def __str__(self) -> str:  # <L,S,C> like the paper
        return f"<{self.L},{self.S},{self.C}>"


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-card resource table (the paper's per-GPU architectural features)."""

    name: str
    sms: int                  # streaming multiprocessors
    max_threads_per_block: int
    smem_per_block: int       # shared memory one block may use, bytes
    l2_bytes: int
    hbm_gbps: float           # device memory bandwidth, GB/s
    source: str               # where the numbers come from


# H100 SXM5 80 GB (NVIDIA H100 data sheet and Hopper architecture white paper).
# ``chip_from_device`` replaces the SM count, L2 size and shared memory with what
# the card itself reports, and the bandwidth with its SKU's data-sheet rate.
CHIPS: dict[str, ChipSpec] = {
    "h100": ChipSpec("h100", sms=132, max_threads_per_block=1024,
                     smem_per_block=232_448, l2_bytes=50 * 2**20,
                     hbm_gbps=3350.0, source="datasheet: H100 SXM5 80GB"),
}

DEFAULT_CHIP = "h100"
# device-memory bandwidth by SKU name, GB/s (NVIDIA data sheets); first match wins
_HBM_GBPS_BY_SKU = (("H100 PCIe", 2000.0), ("H100 NVL", 3900.0), ("H100", 3350.0))

# Fixed per-pattern geometries for the card (no tuning yet).  FP: four loop
# iterations of 256 threads, one element each, so a warp's loads and stores of
# neighbouring elements are neighbouring words.  GP: one thread per output
# element; the binary search dominates, more work per thread buys nothing.
_NATIVE: dict[str, dict[str, Geometry]] = {
    "h100": {"fp": Geometry(4, 256, 1), "gp": Geometry(1, 256, 1)},
}


def chip_from_device(device_index: int = 0, name: str = DEFAULT_CHIP) -> ChipSpec:
    """``CHIPS[name]`` with the entries the card reports read from the card
    (``torch.cuda.get_device_properties``) and the bandwidth of its SKU."""
    import torch

    p = torch.cuda.get_device_properties(device_index)
    base = CHIPS[name]
    sku = next(((s, bw) for s, bw in _HBM_GBPS_BY_SKU if s in p.name),
               (base.source, base.hbm_gbps))
    return dataclasses.replace(
        base, sms=int(p.multi_processor_count), hbm_gbps=sku[1],
        max_threads_per_block=int(getattr(p, "max_threads_per_block",
                                          base.max_threads_per_block)),
        smem_per_block=int(getattr(p, "shared_memory_per_block_optin",
                                   base.smem_per_block)),
        l2_bytes=int(getattr(p, "L2_cache_size", base.l2_bytes)),
        source=f"{p.name} (device properties); bandwidth: datasheet {sku[0]}")


def native_config(pattern: str, chip: str = DEFAULT_CHIP) -> Geometry:
    """The fixed geometry of ``pattern`` ("fp" or "gp") on a chip."""
    return _NATIVE[chip][pattern]
