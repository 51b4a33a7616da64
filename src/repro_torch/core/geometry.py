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

Per pattern, ``fp_space``/``gp_space``/``np_space`` (``SPACES``) list the
geometries the kernel accepts, powers of two only as in the paper's Table 3:
S is threads per block (whole warps, up to what the card and the kernel's
registers allow), C outputs per thread per iteration (chunks per thread for
NP), L main-loop iterations.  ``smem_bytes`` is a geometry's shared-memory
footprint per pattern, the port's counterpart of the reference's
``Geometry.vmem_bytes``.  ``analytic_cost_ns`` models a launch's device time
on a ``ChipSpec`` (``core/autotune.py`` searches the spaces with it or with a
measurement).

``native_config`` does not take the model's argmin, as the reference's does
(it had no chip to measure on): it returns one measured geometry per pattern
for the card (``_NATIVE``).  What the tuner finds on the card is recorded by
``chip_smoke.py``'s ``geometry`` lines, not applied here.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Iterable


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
    # per-SM limits that bound how many blocks run at once (NVIDIA CUDA C++
    # Programming Guide, technical specifications of compute capability 9.0)
    regs_per_sm: int = 65536          # 32-bit registers of an SM, and of one block
    max_threads_per_sm: int = 2048
    max_blocks_per_sm: int = 32
    smem_per_sm: int = 233_472        # 228 KB of shared memory on an SM
    int32_ops_per_ns: float = 33_500.0   # INT32 rate outside the tensor cores
                                         # (H100 SXM5 data sheet: 33.5 TOP/s)


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


# ----------------------------------------------------------------------- spaces
# What the kernels take (csrc/*.cu): kernel 1 stages a block's bit-packed words
# in at most ZF_FP_MAX_SMEM bytes and takes its per-element global path past
# that; kernel 2 stages a sub-tile's S*C + 2 presum entries (and one or two
# values per group) in at most ZF_GP_MAX_SMEM bytes and walks global memory
# past that; kernel 3 keeps ZF_NP_LOOKAHEAD ring words per thread beside its
# 21,504 bytes of static tables.
FP_MAX_SMEM = 96 * 1024
GP_MAX_SMEM = 96 * 1024
NP_LOOKAHEAD = 16
NP_STATIC_SMEM = 21_504
# Registers per thread the kernels' instances take at most, rounded up to the
# allocation unit of 8: `-Xptxas -v` of the sm_90a builds (nvcc 12.8, as
# chip_smoke.py prints them; it fails if a build takes more).  They bound S:
# a block of S threads needs S x regs of the SM's register file.
KERNEL_REGS = {"fp": 48, "gp": 88, "np": 96}
_L = (1, 2, 4, 8, 16)
_C = (1, 2, 4, 8, 16)


def _threads(spec: ChipSpec, pattern: str) -> tuple[int, ...]:
    """Powers of two from a warp up to what the card and the kernel's registers allow."""
    top = min(spec.max_threads_per_block, spec.regs_per_sm // KERNEL_REGS[pattern])
    return tuple(1 << k for k in range(5, 11) if 1 << k <= top)


def smem_bytes(pattern: str, geom: Geometry, itemsize: int = 4) -> int:
    """Shared memory one block of ``geom`` takes (dynamic and static), as the
    kernel sizes it; ``itemsize`` is the output width.  Kernel 1: the staged
    words of a bit-packed source of ``8 * itemsize`` bits an output, capped at
    ``FP_MAX_SMEM``; kernel 2: the presum window and two values a group (its
    most, DeltaStride's start and stride), capped at ``GP_MAX_SMEM``; kernel 3:
    the lookahead ring and its tables."""
    if pattern == "fp":
        words = (geom.tile * itemsize + 3) // 4 + 4
        return min(-(-words // 4) * 16, FP_MAX_SMEM)
    if pattern == "gp":
        return min(4 + (geom.S * geom.C + 1) * 12, GP_MAX_SMEM)
    return NP_STATIC_SMEM + NP_LOOKAHEAD * 4 * geom.S


def _spills(pattern: str, geom: Geometry, itemsize: int) -> bool:
    """Whether a block's window outgrows the kernel's shared buffer (the slow,
    valid path: the counterpart of the reference's VMEM cliff)."""
    if pattern == "fp":
        return ((geom.tile * itemsize + 3) // 4 + 4) * 4 > FP_MAX_SMEM
    if pattern == "gp":
        return 4 + (geom.S * geom.C + 1) * 12 > GP_MAX_SMEM
    return False


def blocks_per_sm(pattern: str, geom: Geometry, spec: ChipSpec, itemsize: int = 4) -> int:
    """Blocks of ``geom`` one SM holds at once: its threads, registers and shared
    memory; 0 when one block does not fit."""
    return min(spec.max_blocks_per_sm, spec.max_threads_per_sm // geom.S,
               spec.regs_per_sm // (KERNEL_REGS[pattern] * geom.S),
               spec.smem_per_sm // smem_bytes(pattern, geom, itemsize))


def _space(pattern: str, spec: ChipSpec, itemsize: int, Ls, Cs) -> Iterable[Geometry]:
    for L in Ls:
        for S in _threads(spec, pattern):
            for C in Cs:
                g = Geometry(L, S, C)
                if smem_bytes(pattern, g, itemsize) <= spec.smem_per_block \
                        and blocks_per_sm(pattern, g, spec, itemsize) >= 1:
                    yield g


def fp_space(spec: ChipSpec, itemsize: int = 4) -> Iterable[Geometry]:
    """Fully-Parallel: L in 2^0..2^4, S a power of two from 32, C in 2^0..2^4
    outputs per thread per iteration (``itemsize`` = output bytes; C =
    16 / itemsize fills one 16-byte store)."""
    return _space("fp", spec, itemsize, _L, _C)


def gp_space(spec: ChipSpec, itemsize: int = 4) -> Iterable[Geometry]:
    """Group-Parallel: L sub-tiles of S*C outputs a block (one group search
    serves them), S at least a warp (warp 0 searches), C outputs a thread."""
    return _space("gp", spec, itemsize, _L, _C)


def np_space(spec: ChipSpec, itemsize: int = 4) -> Iterable[Geometry]:
    """Non-Parallel: S threads of one chunk each at a time, C chunks a thread
    in turn, L such rounds a block (a block covers L*S*C chunks)."""
    return _space("np", spec, itemsize, (1, 2, 4, 8), (1, 2, 4, 8))


SPACES: dict[str, Callable[..., Iterable[Geometry]]] = {
    "fp": fp_space,
    "gp": gp_space,
    "np": np_space,
}


# ------------------------------------------------------------------- cost model
# Constants of the model beyond the chip's table.  NP_STEP_NS is measured:
# kernel 3's chain floor, 0.198-0.201 ms for 4,096 dependent steps (an NVIDIA
# H100 80GB HBM3 at 700 W, scripts/kernel_variants.py `bare-chain`).  The
# others are assumptions of the model, not measurements; chip_smoke.py's
# `geometry` lines report the rank correlation of the model with the times the
# card measures, which is how far to trust them.
NP_STEP_NS = 48.6           # one rANS step's dependent chain
MEM_LATENCY_NS = 600.0      # one dependent device-memory round trip
INFLIGHT_BYTES_PER_SM = 16_384   # bytes an SM keeps in flight to reach the HBM rate
BLOCK_NS = 150.0            # a block's start and end (index math, first loads, sync)
ITER_OPS = 12               # integer operations of a thread's loop iteration
ELEM_OPS = {"fp": 6, "gp": 10, "np": 12}   # per output, on the fast path
ROLLED = 3.0                # the rolled per-element path against the unrolled store
CLIFF = 4.0                 # a window past the shared buffer: global-memory walks


def analytic_cost_ns(pattern: str, geom: Geometry, n_elems: int, itemsize: int,
                     spec: ChipSpec, bytes_in: int | None = None,
                     bytes_out: int | None = None, chunk_size: int = 4096) -> float:
    """Modeled device time of one launch of ``pattern`` at ``geom`` over
    ``n_elems`` outputs of ``itemsize`` bytes (kernel 3: ``n_elems`` symbols in
    chunks of ``chunk_size``, one chunk a thread at a time).  The sum of:

      * HBM bytes at ``hbm_gbps``, at a rate that saturates with the bytes in
        flight: the running blocks (at most ``sms`` x the blocks an SM holds
        at the threads, registers and shared memory a block takes) times S
        threads times each thread's C outputs, against
        ``INFLIGHT_BYTES_PER_SM`` an SM; stretched by the idle slots of the
        last wave (half a wave's worth, smoothly), and by ``CLIFF`` where a
        block's window outgrows the kernel's shared buffer;
      * instruction issue at ``int32_ops_per_ns``: a loop iteration's overhead
        per C outputs and each output's operations, times ``ROLLED`` when
        C * itemsize is not one 16-byte store (narrower stores, or the rolled
        path); kernel 2 adds its in-window binary search per C outputs;
      * a per-block cost per wave: ``BLOCK_NS``, for kernel 2 the group search
        (a dependent memory round per 33-way probe) and a window staging per
        sub-tile, for kernel 3 building its table;
      * kernel 3 only, in place of the memory term when larger: its chains,
        ``chunk_size`` steps of ``NP_STEP_NS`` for each of the L*C chunks a
        thread decodes in turn, per wave.

    Along each of L, S and C the model falls, then rises (a larger block
    amortizes its fixed cost until too few blocks keep the SMs and memory
    busy), which is what ``autotune.pruned_search`` relies on."""
    bytes_out = n_elems * itemsize if bytes_out is None else bytes_out
    bytes_in = bytes_out if bytes_in is None else bytes_in
    total = bytes_in + bytes_out
    bps = blocks_per_sm(pattern, geom, spec, itemsize)
    if bps < 1:
        return math.inf
    slots = spec.sms * bps
    units = -(-n_elems // chunk_size) if pattern == "np" else n_elems
    grid = max(1, -(-units // geom.tile))
    waves = max(1.0, grid / slots)
    running = min(grid, slots)
    # each running thread's bytes in flight: its C outputs and their inputs
    # (kernel 3: its ring of lookahead words)
    per_thread = NP_LOOKAHEAD * 4 if pattern == "np" else geom.C * total / max(1, n_elems)
    inflight = running * geom.S * per_thread / (INFLIGHT_BYTES_PER_SM * spec.sms)
    eff = 1.0 - math.exp(-inflight)
    tail = 1.0 + 0.5 * min(1.0, slots / grid)
    mem_ns = total / spec.hbm_gbps / eff * tail
    if _spills(pattern, geom, itemsize):
        mem_ns *= CLIFF
    store = 1.0 if pattern == "np" or geom.C * itemsize == 16 else ROLLED
    ops = n_elems * ELEM_OPS[pattern] * store + (units / geom.C) * ITER_OPS
    if pattern == "gp":
        ops += (n_elems / geom.C) * 2 * math.log2(geom.S * geom.C + 2)
    issue_ns = ops / spec.int32_ops_per_ns
    fixed = BLOCK_NS
    if pattern == "gp":
        rounds = max(1, math.ceil(math.log(max(2, n_elems), 33)))
        fixed += rounds * MEM_LATENCY_NS + geom.L * 2 * MEM_LATENCY_NS
    elif pattern == "np":
        fixed += math.ceil(4096 / geom.S) * 4 * MEM_LATENCY_NS / 16
    block_ns = waves * fixed
    if pattern == "np":
        rounds = min(geom.L * geom.C, -(-units // geom.S))
        mem_ns = max(mem_ns, waves * rounds * chunk_size * NP_STEP_NS)
    return mem_ns + issue_ns + block_ns
