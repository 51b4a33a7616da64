"""ZipFlow compiler: DecodeGraph -> executable decode program.

The pipeline is ``plan.lower_graph`` -> ``fusion.fuse_graph`` -> ``compile_graph``;
programs live in a ``ProgramCache`` keyed by the graph's structure-only signature,
the backend and the launch geometry, so structurally identical columns share one program even
when their data-dependent meta differs: programs are *called* with an operand dict
(leaf buffers + lifted meta scalars, ``plan.host_operands`` staged on the device),
never specialized on meta values.

Backends:
  * "kernel"   -- the hand-written CUDA kernels of ``repro_torch.kernels`` (the
                  card's main path), at each pattern's native geometry or at
                  the ``geometry`` a caller gives (``{"fp"|"gp"|"np": Geometry}``);
  * "torch"    -- the plain PyTorch versions (the CPU backend, and the
                  comparison the card runs against the kernels);
  * "baseline" -- the nvCOMP role of the paper's §5.2/§5.3: the same kernels,
                  **unfused** (every stage writes its output to device memory)
                  at one fixed library geometry, ``BASELINE_GEOMS``, not adapted
                  to the card.  On CPU tensors the kernels' wrappers run their
                  plain versions, as for "kernel".
PyTorch runs eagerly, so a program is the fused stage list and its backend; the
one-time cost of a structure is building the CUDA libraries, done once per
process (``repro_torch.kernels.cuda``).

``Program.batched`` decodes K columns of one structure at once (the planner's
``BATCHED`` decision): one launch per stage of the kernels' batched entries,
each column with its own operands, into the rows of one ``(K, n_out)`` result.

Streamed decode adds three programs, cached per structure like the whole one:
``ChunkProgram`` (one element chunk), ``PrologueProgram`` (what precedes a
graph's group stage, once per column) and ``GroupChunkProgram`` (one span of
whole groups); a fused query adds ``QueryChunkProgram`` (one chunk of items
into a partial aggregate).  Each calls the stages' chunk or span entries through
``kernels/ops.run_stage`` with its offsets and writes its range of the
column's output in place, so no concatenation follows.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import fusion as fusion_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core.geometry import DEFAULT_CHIP, Geometry, chip as chip_spec
from repro_torch.core.ir import (DecodeGraph, element_chunk_layout, group_chunk_layout,
                                 query_chunk_layout)
from repro_torch.core.patterns import LOAD, GroupParallel, Stage
from repro_torch.kernels.ops import BACKENDS as STAGE_BACKENDS
from repro_torch.kernels.ops import run_stage, run_stage_batched
from repro_torch.kernels.ref import torch_dtype

BACKENDS = STAGE_BACKENDS + ("baseline",)

# The baseline's one library geometry for every pattern and output width: one
# output (Non-Parallel: one chunk) per thread per block of 128 threads, the
# shape a general-purpose library launches without knowing the card or the
# stage (the reference's <1, 8, 128> reads the same idea the TPU way: one
# sublane group of one lane row).  It gives up what the native table buys:
# 16-byte stores (C * width = 16), several sub-tiles a block, larger blocks.
BASELINE_GEOMS = {"fp": Geometry(1, 128, 1), "gp": Geometry(1, 128, 1),
                  "np": Geometry(1, 128, 1)}


def stage_backend(backend: str, geometry: dict[str, Geometry] | None = None
                  ) -> tuple[str, dict[str, Geometry] | None]:
    """What ``run_stage`` takes for a program's backend: "baseline" is the
    kernel backend at ``BASELINE_GEOMS``."""
    if backend == "baseline":
        return "kernel", BASELINE_GEOMS
    return backend, geometry


def fuses(backend: str, fuse: bool = True) -> bool:
    """Whether a program of ``backend`` is compiled from the fused graph: the
    baseline never is (``src/repro/core/compiler.py`` ``compile_blob``)."""
    return fuse and backend != "baseline"


@dataclasses.dataclass
class Program:
    """One decode program, shared by every blob with the same signature;
    ``geometry`` maps a pattern to its launch geometry (None: the native
    table; the baseline's is ``BASELINE_GEOMS``)."""

    graph: DecodeGraph
    backend: str
    geometry: dict[str, Geometry] | None = None
    calls: int = 0              # single-column decodes
    batched_calls: int = 0      # batched decodes

    @property
    def signature(self) -> str:
        return self.graph.signature

    @property
    def stages(self) -> list[Stage]:
        return self.graph.stages

    @property
    def n_kernels(self) -> int:
        """Stages of the program, the reference's count of its launches."""
        return len(self.graph.stages)

    def __call__(self, bufs: dict[str, torch.Tensor]) -> torch.Tensor:
        """Decode one column from its staged operands (no host sync inside)."""
        self.calls += 1
        backend, geoms = stage_backend(self.backend, self.geometry)
        env = dict(bufs)
        out = None
        for st in self.graph.stages:
            out = run_stage(st, env, backend, geoms=geoms)
            env[st.out] = out
        return out

    def batched(self, members) -> torch.Tensor:
        """Decode K columns of this structure, one operand dict each, in one
        launch per stage (the reference stacks the operands and vmaps; each
        member here keeps its own buffers).  Returns ``(K, n_out)``; each row
        starts on a 16-byte boundary, so the kernels store whole 16-byte groups
        in every member's output."""
        members = [dict(m) for m in members]
        if not members:
            raise ValueError("a batched decode needs at least one member")
        self.batched_calls += 1
        graph = self.graph
        out_dt = torch_dtype(graph.out_dtype)
        device = next(iter(members[0].values())).device
        per_row = 16 // math.gcd(16, out_dt.itemsize)      # elements per 16 bytes
        pad = -(-graph.n_out // per_row) * per_row
        rows = torch.empty((len(members), pad), dtype=out_dt, device=device)
        last = len(graph.stages) - 1
        backend, geoms = stage_backend(self.backend, self.geometry)
        for k, st in enumerate(graph.stages):
            outs = [rows[i, :graph.n_out] for i in range(len(members))] if k == last else None
            for env, res in zip(members, run_stage_batched(st, members, backend, outs=outs,
                                                           geoms=geoms)):
                env[st.out] = res
        return rows[:, :graph.n_out]


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")


def compile_graph(graph: DecodeGraph, backend: str = "torch", chip: str = DEFAULT_CHIP,
                  geometry: dict[str, Geometry] | None = None) -> Program:
    """Compile a DecodeGraph to a Program (no caching -- see ProgramCache).
    ``geometry`` overrides the native geometry of the patterns it names; the
    baseline takes ``BASELINE_GEOMS`` whatever is given.  ``chip`` names the
    ``ChipSpec`` (the port knows one card; the native table is its)."""
    _check_backend(backend)
    chip_spec(chip)
    if backend == "baseline":
        # fixed library geometry, deliberately not adapted to the card (paper §5.2)
        geometry = dict(BASELINE_GEOMS)
    return Program(graph=graph, backend=backend,
                   geometry=dict(geometry) if geometry else None)


@dataclasses.dataclass
class ChunkProgram:
    """Per-chunk decode of an element-chunkable graph: one call decodes output
    elements ``[out_start, out_start + chunk_elems)`` from the chunk's slices of
    the tiled leaves (plus the whole-resident tables and meta operands) into
    that range of ``out``.  Chunk boundaries are multiples of the layout's
    ``align``, so every slice starts at the chunk's first element and each
    stage runs over local indices ``0 .. chunk_elems``."""

    graph: DecodeGraph
    chunk_elems: int
    backend: str
    calls: int = 0

    def __call__(self, bufs: dict[str, torch.Tensor], out_start: int,
                 out: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        env = dict(bufs)
        n = self.chunk_elems
        last = len(self.graph.stages) - 1
        backend, geoms = stage_backend(self.backend)
        for k, st in enumerate(self.graph.stages):
            dst = out[out_start:out_start + n] if k == last else None
            env[st.out] = run_stage(st, env, backend, n=n, out=dst, geoms=geoms)
        return out


def compile_chunk_graph(graph: DecodeGraph, chunk_elems: int,
                        backend: str = "torch") -> ChunkProgram:
    _check_backend(backend)
    if element_chunk_layout(graph) is None:
        raise ValueError(f"graph {graph.nesting!r} is not element-chunkable")
    return ChunkProgram(graph=graph, chunk_elems=int(chunk_elems), backend=backend)


@dataclasses.dataclass
class QueryChunkProgram:
    """Per-chunk fused-query program: one call evaluates scan-filter-aggregate
    over the items ``[out_start, out_start + chunk_elems)`` and gives a partial
    aggregate (``graph.n_out`` accumulator lanes), not decoded rows: one launch
    of the query kernel on the kernel backend.  Tiled inputs are the chunk's
    slices, read at local indices (chunk starts are multiples of the layout's
    ``align``, as for ``ChunkProgram``); resident "row" inputs are whole and
    read at the global item.  ``out`` receives the lanes, or has them added
    (``accumulate``), so the executor sums the chunks in order on the device.
    Body chunks share one program per size, the uneven tail gets a second."""

    graph: DecodeGraph
    chunk_elems: int
    backend: str
    calls: int = 0

    def __call__(self, bufs: dict[str, torch.Tensor], out_start: int,
                 out: torch.Tensor | None = None, accumulate: bool = False) -> torch.Tensor:
        self.calls += 1
        env = dict(bufs)
        n = self.chunk_elems
        *pre, red = self.graph.stages
        backend, geoms = stage_backend(self.backend)
        for st in pre:      # Fully-Parallel stages fusion left standing
            env[st.out] = run_stage(st, env, backend, n=n, geoms=geoms)
        return run_stage(red, env, backend, out=out, n=n, out_start=int(out_start),
                         accumulate=accumulate)


def compile_query_chunk_graph(graph: DecodeGraph, chunk_elems: int,
                              backend: str = "torch") -> QueryChunkProgram:
    """The per-chunk program of a fused query (Reduce-terminated) graph."""
    _check_backend(backend)
    if query_chunk_layout(graph) is None:
        raise ValueError(f"graph {graph.nesting!r} is not query-chunkable")
    return QueryChunkProgram(graph=graph, chunk_elems=int(chunk_elems), backend=backend)


@dataclasses.dataclass
class PrologueProgram:
    """One decode of everything before a graph's group stage (presum Aux ops,
    nested child decodes) over whole-resident leaves; returns the resident
    intermediates the span launches read."""

    graph: DecodeGraph
    backend: str
    calls: int = 0

    def __call__(self, bufs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        self.calls += 1
        layout = group_chunk_layout(self.graph)
        env = dict(bufs)
        backend, geoms = stage_backend(self.backend)
        for st in self.graph.stages[:layout.stage_index]:
            env[st.out] = run_stage(st, env, backend, geoms=geoms)
        return {nm: env[nm] for nm in layout.resident}


def _has_prologue(graph: DecodeGraph) -> bool:
    """Whether the spans read anything that precedes the group stage."""
    layout = group_chunk_layout(graph)
    if layout is None:
        raise ValueError(f"graph {graph.nesting!r} is not group-chunkable")
    return layout.stage_index > 0 and bool(layout.resident)


def compile_group_prologue(graph: DecodeGraph,
                           backend: str = "torch") -> PrologueProgram | None:
    """None when nothing the spans read precedes the group stage."""
    _check_backend(backend)
    return PrologueProgram(graph=graph, backend=backend) if _has_prologue(graph) else None


def span_stage(graph: DecodeGraph):
    """The group stage as each span runs it.  A value input the layout grafts
    (``span_graft``: StringDict's index, also read by the word-length prologue
    the host-pushed presum replaces) is re-evaluated from its Fully-Parallel
    producer: the producer's chain replaces the value chain's ``LOAD``, as
    fusion rule 2 would have done had the index had one consumer, so the
    kernel decodes it at ``g - g_start`` from the span's slice of the packed
    leaf."""
    layout = group_chunk_layout(graph)
    gst = graph.stages[layout.stage_index]
    if not layout.span_graft:
        return gst
    values, inputs, specs = [], [], []
    for chain in gst.values:
        src = chain[0]
        if src.kind == LOAD and src.bufs[0] in layout.span_graft:
            chain = graph.stages[layout.span_graft[src.bufs[0]]].chain + chain[1:]
        values.append(chain)
    for name, spec in zip(gst.value_inputs, gst.value_specs):
        if name in layout.span_graft:
            prod = graph.stages[layout.span_graft[name]]
            pairs = zip(prod.inputs, prod.specs)
        else:
            pairs = ((name, spec),)
        for nm, sp in pairs:
            if nm not in inputs:
                inputs.append(nm)
                specs.append(sp)
    return dataclasses.replace(gst, values=tuple(values), value_inputs=tuple(inputs),
                               value_specs=tuple(specs), identity_values=False)


@dataclasses.dataclass
class GroupChunkProgram:
    """Per-span decode of a group-chunkable graph: one call decodes the
    ``g_size`` whole groups from ``g_start``, the ``n_valid`` outputs from
    ``out_start``, into that range of ``out``.

    A Group-Parallel span searches the whole-resident presum at global output
    indices and evaluates its value chains at ``g - g_start`` over its slices
    (kernel 2's span entry); a Non-Parallel span decodes its own stripe of the
    rANS streams (kernel 3 with ``n_chunks = g_size`` and the stripe's row cap
    as ``max_words``), cut at the end of the stream.  Trailing Fully-Parallel
    stages run over the span's local intermediates.  The reference pads a
    span's launch to ``pad_elems`` and trims; writing the ``n_valid`` outputs in
    place gives the same bits.  ``pad_elems`` stays in the cache key, so body
    spans share one program and the tail gets a second, as in the reference.
    ``base`` is the global index of ``out``'s first element: 0 for a whole
    column, a mesh shard's first output for a shard-sized ``out``; the
    kernels still take the global ``out_start`` and ``g_start``."""

    graph: DecodeGraph
    g_size: int
    pad_elems: int
    backend: str
    calls: int = 0

    def __post_init__(self):
        layout = group_chunk_layout(self.graph)
        self._stage = span_stage(self.graph)
        self._post = self.graph.stages[layout.stage_index + 1:]

    def __call__(self, bufs: dict[str, torch.Tensor], out_start: int, g_start: int,
                 n_valid: int, out: torch.Tensor, base: int = 0) -> torch.Tensor:
        self.calls += 1
        env = dict(bufs)
        gst = self._stage
        final = out[out_start - base:out_start - base + n_valid]
        dst = None if self._post else final
        backend, geoms = stage_backend(self.backend)
        if isinstance(gst, GroupParallel):
            env[gst.out] = run_stage(gst, env, backend, out=dst, geoms=geoms,
                                     out_start=out_start, g_start=g_start,
                                     n_valid=n_valid, g_size=self.g_size)
        else:
            # symbols (bytes) of this span, the last span cut at the stream's end
            cs = gst.chunk_size
            n_sym = min(self.g_size * cs, gst.n_out - g_start * cs)
            env[gst.out] = run_stage(gst, env, backend, out=dst, geoms=geoms,
                                     n_chunks=self.g_size, n=n_sym)
        for k, st in enumerate(self._post):
            dst = final if k == len(self._post) - 1 else None
            env[st.out] = run_stage(st, env, backend, n=n_valid, out=dst, geoms=geoms)
        return out


def compile_group_chunk_graph(graph: DecodeGraph, g_size: int, pad_elems: int,
                              backend: str = "torch") -> GroupChunkProgram:
    _check_backend(backend)
    if group_chunk_layout(graph) is None:
        raise ValueError(f"graph {graph.nesting!r} is not group-chunkable")
    return GroupChunkProgram(graph=graph, g_size=int(g_size), pad_elems=int(pad_elems),
                             backend=backend)


def _geometry_key(geometry: dict[str, Geometry] | None):
    if geometry is None:
        return None
    return tuple(sorted(geometry.items()))


class ProgramCache:
    """Signature-keyed cache of compiled programs: one program per *structure*.

    The whole-column key is (graph signature, backend, geometry); the chunk,
    span and query programs run at the native geometry (the baseline's at its
    own) and are keyed as in the reference, without one.  Everything
    value-dependent is already folded into the signature by the IR layer.
    ``max_programs`` bounds the cache LRU-style (None = unbounded).
    """

    def __init__(self, max_programs: int | None = None):
        self._programs: dict[tuple, Any] = {}   # insertion order = LRU order
        self._lock = threading.Lock()
        self._compiling: dict[tuple, threading.Lock] = {}   # per-key compile guard
        self.max_programs = max_programs
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"programs": len(self._programs), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}

    def _lookup(self, key: tuple):
        """Under self._lock: hit bookkeeping + LRU refresh."""
        prog = self._programs.get(key)
        if prog is not None:
            self.hits += 1
            if self.max_programs is not None:       # refresh LRU position
                self._programs[key] = self._programs.pop(key)
        return prog

    def _get(self, key: tuple, build: Callable[[], Any]):
        # Double-checked: fast-path lookup under self._lock, then a per-key
        # compile lock, then a re-lookup under self._lock before building, so
        # racing threads build each key exactly once.
        with self._lock:
            prog = self._lookup(key)
            if prog is not None:
                return prog
            key_lock = self._compiling.setdefault(key, threading.Lock())
        with key_lock:
            try:
                with self._lock:
                    prog = self._lookup(key)
                    if prog is not None:
                        return prog
                prog = build()
                with self._lock:
                    self._programs[key] = prog
                    self.misses += 1
                    while (self.max_programs is not None
                           and len(self._programs) > self.max_programs):
                        self._programs.pop(next(iter(self._programs)))
                        self.evictions += 1
            finally:
                with self._lock:
                    self._compiling.pop(key, None)
        return prog

    def get(self, graph: DecodeGraph, backend: str = "torch", chip: str = DEFAULT_CHIP,
            geometry: dict[str, Geometry] | None = None) -> Program:
        key = (graph.signature, backend, _geometry_key(geometry))
        return self._get(key, lambda: compile_graph(graph, backend=backend, chip=chip,
                                                    geometry=geometry))

    def get_chunk(self, graph: DecodeGraph, chunk_elems: int,
                  backend: str = "torch") -> ChunkProgram:
        """One per (structure, chunk size): every body chunk of every column of
        the structure shares it, and an uneven tail gets a second."""
        key = (graph.signature, "chunk", int(chunk_elems), backend)
        return self._get(key, lambda: compile_chunk_graph(graph, chunk_elems, backend))

    def get_query_chunk(self, graph: DecodeGraph, chunk_elems: int,
                        backend: str = "torch") -> QueryChunkProgram:
        """One per (structure, chunk size): body chunks share it, the uneven
        tail gets a second."""
        key = (graph.signature, "qchunk", int(chunk_elems), backend)
        return self._get(key, lambda: compile_query_chunk_graph(graph, chunk_elems,
                                                                backend))

    def get_group_chunk(self, graph: DecodeGraph, g_size: int, pad_elems: int,
                        backend: str = "torch") -> GroupChunkProgram:
        """One per (structure, groups per span, padded span shape)."""
        key = (graph.signature, "gchunk", int(g_size), int(pad_elems), backend)
        return self._get(key, lambda: compile_group_chunk_graph(
            graph, g_size, pad_elems, backend))

    def get_group_prologue(self, graph: DecodeGraph,
                           backend: str = "torch") -> PrologueProgram | None:
        """The prologue of a group-chunkable graph; None when the group stage
        reads nothing a prologue makes (nothing is cached then)."""
        if not _has_prologue(graph):
            return None
        key = (graph.signature, "gprologue", backend)
        return self._get(key, lambda: compile_group_prologue(graph, backend))


def build_graph(enc: plan_mod.Encoded, fuse: bool = True) -> DecodeGraph:
    """Lower + (optionally) fuse: the front half of the compile pipeline."""
    graph = plan_mod.lower_graph(enc)
    return fusion_mod.fuse_graph(graph) if fuse else graph


def compile_blob(enc: plan_mod.Encoded, backend: str = "torch", fuse: bool = True,
                 chip: str = DEFAULT_CHIP, geometry: dict[str, Geometry] | None = None,
                 cache: ProgramCache | None = None) -> Program:
    """Blob -> cached Program.  Without a ``cache`` the program is built fresh.
    The baseline is never fused."""
    graph = build_graph(enc, fuse=fuses(backend, fuse))
    if cache is None:
        return compile_graph(graph, backend=backend, chip=chip, geometry=geometry)
    return cache.get(graph, backend=backend, chip=chip, geometry=geometry)


@dataclasses.dataclass
class CompiledDecoder:
    """The per-blob handle of the reference's compatibility shim: a view of a
    Program (``fn`` is the program itself)."""

    fn: Callable[[dict[str, torch.Tensor]], torch.Tensor]
    stages: list[Stage]
    backend: str
    n_kernels: int
    program: Program | None = None

    def __call__(self, bufs: dict[str, torch.Tensor]) -> torch.Tensor:
        if self.program is not None:
            return self.program(bufs)
        return self.fn(bufs)


def compile_decoder(enc: plan_mod.Encoded, backend: str = "kernel", fuse: bool = True,
                    chip: str = DEFAULT_CHIP, geometry: dict[str, Geometry] | None = None
                    ) -> CompiledDecoder:
    """A blob's decoder, built fresh (no cache), on ``backend``."""
    prog = compile_blob(enc, backend=backend, fuse=fuse, chip=chip, geometry=geometry)
    return CompiledDecoder(fn=prog, stages=prog.stages, backend=backend,
                           n_kernels=prog.n_kernels, program=prog)


# ------------------------------------------------------------- device operands

def device_layout(arr: np.ndarray) -> np.ndarray:
    """A host operand in the 32-bit layout the device works in.

    The reference runs JAX with 64-bit types off, so int64 leaves (zigzag deltas,
    float2int ints, their dictionaries) reach its device as int32, wrapped; the
    port does the same here.  uint32 words travel as an int32 view of the same
    bits, since torch has few uint32 operators."""
    a = np.ascontiguousarray(arr)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype in (np.int64, np.uint64):
        return a.astype(np.int32)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    return a


def device_buffers(enc: plan_mod.Encoded,
                   device: torch.device | str = "cuda") -> dict[str, torch.Tensor]:
    """Move a blob's operands host->device: leaf buffers (the compressed transfer
    itself) plus the lifted meta operands the program consumes at call time."""
    return {k: torch.from_numpy(device_layout(v)).to(device)
            for k, v in plan_mod.host_operands(enc).items()}


def decode_on_device(enc: plan_mod.Encoded, backend: str = "kernel",
                     device: torch.device | str = "cuda", **kw: Any) -> torch.Tensor:
    """One-shot helper: transfer + decode (on the card unless ``device`` says
    otherwise; keywords go to ``compile_decoder``)."""
    return compile_decoder(enc, backend=backend, **kw)(device_buffers(enc, device))
