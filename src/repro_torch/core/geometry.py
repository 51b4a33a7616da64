"""Kernel launch geometry: the paper's <L, S, C> configuration vector (§4), read
the paper's own GPU way.

    L  -> main-loop iterations of each thread,
    S  -> threads per block,
    C  -> contiguous elements each thread produces per iteration.

One block covers L*S*C output elements; grid = ceil(N / (L*S*C)).

For the Non-Parallel (rANS) kernel the unit is a *chunk*, not an element:
S is threads per block and C chunks per thread (decoded one after another), so
a block covers L*S*C chunks and each chunk's ``chunk_size`` serial steps run in
one thread.

The reference package re-derives these for TPU VMEM tiles and picks a chip's
"native" geometry with an analytic cost model and autotuner; those come over in
a later slice.  Until then ``native_config`` returns one fixed geometry per
pattern for the card.
"""
from __future__ import annotations

import dataclasses
import functools
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
    host_link_gbps: float     # host->device copy rate, GB/s (the cost model's link)
    grid_step_overhead_ns: float  # cost of one more decode launch (the cost model's)
    source: str               # where the numbers come from


# H100 SXM5 80 GB (NVIDIA H100 data sheet and Hopper architecture white paper).
# ``chip_from_device`` replaces the SM count, L2 size and shared memory with what
# the card itself reports, and the bandwidth with its SKU's data-sheet rate.
#
# The two cost-model entries are measured on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit by ``chip_smoke.py`` (SF 1, seed 0):
#  - host_link_gbps: 48.8 GB/s, the 444.32 MB of plain TPC-H columns copied
#    from pinned memory to the card in 9.11 ms;
#  - grid_step_overhead_ns: 254,000 ns, what one more decode unit adds to the
#    wall time of ``StreamingExecutor.run`` (the host time of the chunked run
#    at 1 MiB less the whole-column run's, over the 85 units chunking adds).
#    The cost model prices one *extra* decode launch with it
#    (``CostModel.launch_overhead_s``), and on this card that is what an extra
#    chunk costs end to end; almost all of it is host time.  The device side
#    of a launch alone is about 6.5 us by CUDA events.
CHIPS: dict[str, ChipSpec] = {
    "h100": ChipSpec("h100", sms=132, max_threads_per_block=1024,
                     smem_per_block=232_448, l2_bytes=50 * 2**20,
                     hbm_gbps=3350.0, host_link_gbps=48.8,
                     grid_step_overhead_ns=254_000.0,
                     source="datasheet: H100 SXM5 80GB"),
}

DEFAULT_CHIP = "h100"
# device-memory bandwidth by SKU name, GB/s (NVIDIA data sheets); first match wins
_HBM_GBPS_BY_SKU = (("H100 PCIe", 2000.0), ("H100 NVL", 3900.0), ("H100", 3350.0))

# Fixed per-pattern geometries for the card (no tuning yet).  FP: 256 threads
# with 16 bytes of output each per iteration (C = 4 at 4-byte outputs, 8 at 2,
# 16 at 1) and L = out_width iterations, so every block covers 4,096 outputs:
# a multiple of 128, so a tile of bit-packed words starts on a 16-byte
# boundary at every bit width, and its staged words (at most 16 KB, at 32
# bits) leave room for eight blocks per SM.  GP: four sub-tiles per block
# of 256 threads with 16 bytes of output each (C = 4 at 4-byte outputs, 8 at
# 2, 16 at 1), so a thread stores once per sub-tile, a sub-tile's window
# (S*C + 2 presum entries) fits shared memory several times over per SM, and
# one group search serves four sub-tiles (L = 1, 2 and 8 timed no faster).
# NP: one chunk per thread in blocks of 64 (32 timed slower), so the
# ~1,500-3,000 chunks of an SF-1 column spread over as many SMs as they can fill.
_NATIVE: dict[str, dict[str, Geometry]] = {
    "h100": {"fp": Geometry(4, 256, 4), "gp": Geometry(4, 256, 4),
             "np": Geometry(1, 64, 1)},
}


def chip(name: str = DEFAULT_CHIP) -> ChipSpec:
    return CHIPS[name]


def chip_from_device(device_index: int = 0, name: str = DEFAULT_CHIP) -> ChipSpec:
    """``CHIPS[name]`` with the entries the card reports read from the card
    (``torch.cuda.get_device_properties``) and the bandwidth of its SKU; the
    measured ``host_link_gbps`` and ``grid_step_overhead_ns`` stay as seeded."""
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


@functools.cache   # a few keys; called per launch, and Geometry is frozen
def native_config(pattern: str, chip: str = DEFAULT_CHIP, out_width: int = 4) -> Geometry:
    """The fixed geometry of ``pattern`` ("fp", "gp" or "np") on a chip.  For
    "fp" and "gp", ``out_width`` (bytes per output element) scales C so that a
    thread always writes 16 bytes; for "fp" it scales L the other way, so a
    block's tile stays the same number of outputs."""
    geom = _NATIVE[chip][pattern]
    if pattern == "gp":
        geom = dataclasses.replace(geom, C=geom.C * 4 // out_width)
    elif pattern == "fp":
        geom = dataclasses.replace(geom, L=geom.L * out_width // 4,
                                   C=geom.C * 4 // out_width)
    return geom


@functools.cache
def native_subtile(pattern: str, chip: str = DEFAULT_CHIP, itemsize: int = 4) -> int:
    """S*C of the chip's native geometry: the outputs one main-loop iteration of
    a block covers.  The planner's chunk ladder snaps element-chunk boundaries
    to multiples of it, so every streamed launch covers whole sub-tiles."""
    pat = pattern if pattern in _NATIVE[chip] else "fp"
    g = native_config(pat, chip, out_width=itemsize)
    return int(g.S) * int(g.C)
