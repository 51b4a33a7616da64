"""Plan-driven streaming decode on one device: whole-column, batched,
chunked-transfer and per-chunk (element or group-span) streaming.

This is the reference's ``StreamingExecutor`` on one device: ``run`` executes an
``ExecutionPlan`` (``core/planner.py``), built from the constructor's knobs --
``chunk_bytes`` (an int, None for whole-blob transfer, or ``"auto"`` for
per-column sizing), ``chunk_decode``, ``policy``, ``pipeline``,
``batch_columns`` and ``prefetch_chunks``, with the reference's defaults --
when the caller passes none.  Per column the plan decides:

  * ``whole`` -- the column moves host->device in one copy (``chunk_bytes=None``)
    or every leaf buffer in row-granular pieces of at most ``chunk_bytes``
    (``split_chunks``), and decodes in one pass through its cached Program once
    its last piece has landed;
  * ``batched`` -- as ``whole``, but columns that the plan marked and that share
    one Program and lie next to each other in the issue order decode together:
    one launch per stage of the kernels' batched entries (``Program.batched``);
  * ``chunk`` -- a column whose graph splits (``chunk_schedule``: element chunks
    of a Fully-Parallel graph, or spans of whole groups behind a Group-Parallel
    or Non-Parallel stage) decodes each chunk in its own launch while later
    chunks are still in flight: the paper's chunk-level overlap.  Every chunk
    writes its range of the column's output in place.  A group-span column
    first runs its prologue (the presum) once, after its whole-resident
    buffers land.

plus the issue order and the window.  Measured actuals feed the plan's
``CostModel`` (``timings`` aliases ``cost_model.measured``), so the next plan is
built from calibrated predictions.  A decision the planner marked ``fused`` (a
pending query could fuse the column) is advisory here, as in the reference:
``run`` decodes the column, and only ``run_query`` fuses.

``run_query`` executes a decode-fused query (``core/query.lower_query``): its
resident columns decode first through ``run``, then one row-axis schedule
streams the fused columns' leaves (pinned staging, the copy stream,
``max(1, window - 1)`` chunks in flight) into one launch per chunk of the
query kernel, whose partial aggregates add up on the device in chunk order.

On a CUDA device:

  * a column's operands are packed into one page-locked host buffer per
    (chunk size, decode mode) the plans ask for, cached: the buffers every
    decode unit reads first, then, for a per-chunk column, the slices of chunk
    0, chunk 1, ... each 256-byte aligned, so the transfer of one chunk is one
    copy of a contiguous range;
  * ``run`` issues those copies on the executor's copy stream into one device
    buffer per column, at most ``window`` decode units ahead of decode (the
    copies of unit u+window wait until the decode of unit u has finished on
    the device); a decode unit is a whole column, a batch of columns or one
    chunk.  The reference's ``window`` counts per-chunk-decode chunks only
    (``scheduler.simulate_stream``); this one counts every unit;
  * the decode of a unit waits on the event recorded after its last copy on
    the compute stream, so transfers overlap decode;
  * ``record_stream`` keeps the caching allocator from reusing a device buffer
    before the compute stream is done with it;
  * ``transfer_s`` runs from a column's first copy to its last, ``decode_s``
    from its first launch to its last (a batch's split evenly among its
    columns), and ``last_makespan_s`` over the run, all by CUDA events.

The host enqueues everything without waiting on the device and synchronizes once
at the end.  On a CPU device the same units run in order, timed with the host
clock.  The dispatch engine comes later.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import costmodel, fusion
from repro_torch.core import plan as plan_mod
from repro_torch.core import planner as planner_mod
from repro_torch.core.compiler import Program, ProgramCache, build_graph, device_layout
from repro_torch.core.costmodel import CostModel, profile_from
from repro_torch.core.ir import (DecodeGraph, element_chunk_layout, group_chunk_layout,
                                 query_chunk_layout)
from repro_torch.core.planner import BATCHED, CHUNK, ColumnDecision, ExecutionPlan
from repro_torch.kernels import cuda
from repro_torch.kernels.fully_parallel import KERNEL as FP_KERNEL
from repro_torch.kernels.group_parallel import KERNEL as GP_KERNEL
from repro_torch.kernels.non_parallel import KERNEL as NP_KERNEL
from repro_torch.kernels.query_reduce import KERNEL as QR_KERNEL
from repro_torch.kernels.ref import torch_dtype

_ALIGN = 256     # byte alignment of each operand inside a staged column
# ragged rANS stripes: a span's row cap is rounded up to this many words, so
# few distinct stripe shapes arise while most of the max_words padding stays home
ROW_CAP_QUANTUM = 64


def split_chunks(arr: np.ndarray, chunk_bytes: int | None) -> list[np.ndarray]:
    """Split a host buffer into pieces of at most ``chunk_bytes`` along axis 0
    (the rANS stream matrix by rows); the pieces concatenate to the buffer."""
    if (chunk_bytes is None or arr.ndim == 0 or arr.nbytes <= chunk_bytes
            or arr.shape[0] <= 1):
        return [arr]
    rows = costmodel.rows_per_chunk(arr.shape[0], arr.nbytes, chunk_bytes)
    return [arr[i:i + rows] for i in range(0, arr.shape[0], rows)]


@dataclasses.dataclass(frozen=True)
class ChunkSchedule:
    """Per-chunk slicing of one column, resolved from its graph's chunk layout
    and its operand values.

    ``kind="element"``: chunk k decodes the ``out_sizes[k]`` elements from
    ``out_starts[k]``.  ``kind="group"``: chunk k decodes the ``g_sizes[k]``
    whole groups from ``g_starts[k]``, ``out_sizes[k]`` valid outputs (the
    reference's launch pads them to ``pad_sizes[k]``).  ``slices`` gives each
    sliced leaf's ``[lo, hi)`` per chunk along ``axes`` (the rANS stripe slices
    columns, capped at ``row_caps`` rows); ``whole`` moves once, shared by the
    chunks; ``host_push`` holds whole buffers staged from host metadata."""

    out_starts: tuple[int, ...]
    out_sizes: tuple[int, ...]
    slices: dict[str, list[tuple[int, int]]]
    whole: tuple[str, ...]
    kind: str = "element"
    g_starts: tuple[int, ...] = ()
    g_sizes: tuple[int, ...] = ()
    pad_sizes: tuple[int, ...] = ()
    axes: dict[str, int] = dataclasses.field(default_factory=dict)
    row_caps: dict[str, tuple[int, ...]] = dataclasses.field(default_factory=dict)
    host_push: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def n_chunks(self) -> int:
        return len(self.out_starts)

    def piece(self, arr: np.ndarray, leaf: str, k: int) -> np.ndarray:
        """Host slice of ``leaf`` for chunk ``k`` (row-capped for stripes)."""
        lo, hi = self.slices[leaf][k]
        if self.axes.get(leaf, 0) == 0:
            return arr[lo:hi]
        caps = self.row_caps.get(leaf)
        rows = int(arr.shape[0]) if caps is None else caps[k]
        return np.ascontiguousarray(arr[:rows, lo:hi])


def element_schedule(ops: dict[str, np.ndarray], layout, n: int,
                     chunk_bytes: int | None) -> ChunkSchedule:
    """Element chunks of ~``chunk_bytes`` of compressed tile bytes (None: one
    chunk of all ``n``) over a chunk layout's tiled leaves (``ChunkLayout`` or
    ``QueryChunkLayout``): boundaries on the layout's alignment, each leaf's
    ``[lo, hi)`` per chunk (the last takes the rest, guard words too)."""
    ratios: dict[str, tuple[int, int]] = {}
    per_elem = 0.0
    for nm, spec in layout.tiled.items():
        num = int(ops[spec.num_op][0]) if spec.num_op else int(spec.num)
        ratios[nm] = (num, int(spec.den))
        per_elem += num / spec.den * np.dtype(ops[nm].dtype).itemsize
    chunk_elems = n if chunk_bytes is None else min(
        n, costmodel.aligned_chunk_elems(chunk_bytes, per_elem, int(layout.align)))
    out_starts = tuple(range(0, n, chunk_elems))
    out_sizes = tuple(min(chunk_elems, n - s) for s in out_starts)
    slices: dict[str, list[tuple[int, int]]] = {}
    for nm, (num, den) in ratios.items():
        length = int(np.asarray(ops[nm]).shape[0])
        per = []
        for s, sz in zip(out_starts, out_sizes):
            lo = (s * num) // den
            # inner boundaries are aligned, so the slices are exact
            hi = length if s + sz >= n else ((s + sz) * num) // den
            per.append((lo, max(hi, lo + 1)))
        slices[nm] = per
    return ChunkSchedule(out_starts=out_starts, out_sizes=out_sizes, slices=slices,
                         whole=tuple(layout.whole))


@dataclasses.dataclass
class ColumnExec:
    """Execution record for one decoded column."""

    name: str
    array: torch.Tensor
    transfer_s: float
    decode_s: float
    compressed_bytes: int
    plain_bytes: int
    n_chunks: int                # transfer pieces, or decode chunks when per-chunk
    signature: str
    batched_with: tuple[str, ...] = ()   # same-structure columns sharing the launch
    decode_launches: int = 1     # decode units: chunks (+ a prologue), or 1
    chunk_decoded: bool = False
    kernel_launches: int = 0     # CUDA kernel launches of this column's decode
    #                              (of a batch: the batch's, shared by its columns)


@dataclasses.dataclass
class QueryExec:
    """Execution record for one decode-fused query (late materialization).

    ``traffic_bytes`` is the fused graph's modeled device-memory traffic (leaf
    reads and the ``n_out`` accumulator lanes); ``prefuse_traffic_bytes``
    prices the same stage list before operator fusion, where every decoded
    column and mask makes a round trip -- the difference is what fusion
    removed.  ``result`` is the finalized aggregate (numpy), ``acc`` the raw
    partial-aggregate lanes on the device.  Besides the reference's fields,
    ``makespan_s`` runs from the first copy (of the resident columns, if any)
    to the last launch's end, by CUDA events on a GPU."""

    name: str
    result: np.ndarray
    acc: torch.Tensor                 # raw partial-aggregate lanes
    transfer_s: float
    decode_s: float
    n_chunks: int
    decode_launches: int
    selectivity: float
    compressed_bytes: int
    plain_bytes: int                  # decoded bytes that were never written
    traffic_bytes: int
    prefuse_traffic_bytes: int
    resident: dict[str, "ColumnExec"] = dataclasses.field(default_factory=dict)
    makespan_s: float = 0.0


Entry = tuple[str, int, int, torch.dtype, tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class StagedColumn:
    """A column's operands packed into one host byte buffer (page-locked for a
    CUDA device).  ``layout`` places what every decode unit reads, ``pieces[k]``
    what only chunk k reads, each entry (name, byte offset, bytes, dtype,
    shape).  ``copies`` are the byte ranges moved one H2D copy each, in order;
    decode unit k needs the first ``needs[k]`` of them."""

    host: torch.Tensor
    layout: tuple[Entry, ...]
    copies: tuple[tuple[int, int], ...]
    needs: tuple[int, ...]
    pieces: tuple[tuple[Entry, ...], ...] = ()

    def views(self, flat: torch.Tensor, k: int | None = None) -> dict[str, torch.Tensor]:
        """The shared operands (and chunk k's slices) as views into ``flat``, a
        device copy of ``host``."""
        entries = self.layout + (self.pieces[k] if k is not None else ())
        return {name: flat[off:off + nb].view(dt).view(shape)
                for name, off, nb, dt, shape in entries}


def _place(arrays, off: int) -> tuple[list[Entry], int]:
    entries = []
    for name, a in arrays:
        entries.append((name, off, a.nbytes, torch_dtype(a.dtype), a.shape))
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    return entries, off


def whole_copies(enc: plan_mod.Encoded, layout, chunk_bytes: int | None
                 ) -> tuple[tuple[int, int], ...]:
    """The copies of a whole-decoded column staged as ``layout`` (meta operands
    first): one, or one per ``split_chunks`` piece of each leaf with the meta
    operands in one."""
    copies: list[tuple[int, int]] = []

    def add(a: int, b: int) -> None:
        if b > a:
            copies.append((a, b))

    if chunk_bytes is None:
        last = layout[-1]
        add(0, last[1] + last[2])
        return tuple(copies)
    ops = plan_mod.host_operands(enc)
    n_meta = len(ops) - len(plan_mod.flat_buffers(enc))
    if n_meta:
        last = layout[n_meta - 1]
        add(0, last[1] + last[2])
    for (name, off, nb, _, shape) in layout[n_meta:]:
        parts = split_chunks(np.asarray(ops[name]), chunk_bytes)
        if len(parts) == 1:
            add(off, off + nb)
            continue
        row, r0 = nb // shape[0], 0      # the pieces' rows, device layout
        for p in parts:
            add(off + r0 * row, off + (r0 + p.shape[0]) * row)
            r0 += p.shape[0]
    return tuple(copies)


def stage_column(enc: plan_mod.Encoded, pin: bool = False,
                 sched: ChunkSchedule | None = None,
                 chunk_bytes: int | None = None) -> StagedColumn:
    """Pack a column for transfer: whole (one copy, or one copy per
    ``split_chunks`` piece of each leaf with the meta operands in one), or per
    chunk of ``sched`` (the whole buffers in one copy, then one per chunk)."""
    ops = plan_mod.host_operands(enc)
    leaves = plan_mod.flat_buffers(enc)
    if sched is not None:
        return stage_chunks(ops, sched, pin)
    names = [k for k in ops if k not in leaves] + list(leaves)   # meta first
    arrays = [(k, device_layout(ops[k])) for k in names]
    layout, end = _place(arrays, 0)
    copies = list(whole_copies(enc, layout, chunk_bytes))
    return _pack(arrays, layout, end, copies, (len(copies),), (), pin)


def stage_chunks(ops: dict[str, np.ndarray], sched: ChunkSchedule,
                 pin: bool = False) -> StagedColumn:
    """Pack operands for per-chunk decode: the whole buffers in one copy, then
    each chunk's slices in one copy each (a column's, or a fused query's
    shared row-axis schedule)."""
    copies: list[tuple[int, int]] = []
    pieces: list[tuple[Entry, ...]] = []
    arrays = [(k, device_layout(sched.host_push[k] if k in sched.host_push
                                else ops[k])) for k in sched.whole]
    layout, end = _place(arrays, 0)
    if end > 0:
        copies.append((0, end))
    needs = []
    for i in range(sched.n_chunks):
        chunk = [(k, device_layout(sched.piece(np.asarray(ops[k]), k, i)))
                 for k in sched.slices]
        entries, stop = _place(chunk, end)
        pieces.append(tuple(entries))
        arrays += chunk
        if stop > end:
            copies.append((end, stop))
        needs.append(len(copies))
        end = stop
    return _pack(arrays, layout, end, copies, tuple(needs), tuple(pieces), pin)


def _pack(arrays, layout, end: int, copies, needs, pieces, pin: bool) -> StagedColumn:
    host = torch.empty(max(end, 1), dtype=torch.uint8, pin_memory=pin)
    for (_, o, nb, _, _), (_, a) in zip(list(layout) + [e for p in pieces for e in p],
                                        arrays):
        host[o:o + nb].copy_(torch.from_numpy(a.reshape(-1).view(np.uint8)))
    return StagedColumn(host=host, layout=tuple(layout), copies=tuple(copies),
                        needs=needs, pieces=pieces)


def _launches() -> int:
    return FP_KERNEL.launches + GP_KERNEL.launches + NP_KERNEL.launches


@dataclasses.dataclass
class _Unit:
    """One decode unit of a run: chunk ``k`` of one column, a whole column
    (``k == 0``), or a batch of whole columns of one Program."""

    members: tuple[str, ...]
    k: int = 0


class StreamingExecutor:
    """Plan-driven streaming decode over cached programs.

    ``chunk_bytes`` (an int, None for whole-blob transfer, or ``"auto"`` for
    per-column sizing), ``chunk_decode``, ``policy``, ``pipeline``,
    ``batch_columns`` and ``prefetch_chunks`` (the window) are planner
    defaults, as in the reference: they parameterize the ``ExecutionPlan``
    built when ``run`` is called without one; a plan passed in is
    authoritative."""

    _DEFAULTS = object()     # "use the constructor's chunk configuration"

    def __init__(self, backend: str, device: torch.device | str,
                 chunk_bytes: int | None | str = 1 << 20, chunk_decode: bool = False,
                 policy: str = "chunk-johnson", pipeline: bool = True,
                 batch_columns: bool = True, prefetch_chunks: int | None = None,
                 cost_model: CostModel | None = None):
        self.backend = backend
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.chunk_bytes = chunk_bytes
        self.chunk_decode = chunk_decode
        self.policy = policy
        self.pipeline = pipeline
        self.batch_columns = batch_columns
        self.prefetch_chunks = None if prefetch_chunks is None else max(1, prefetch_chunks)
        self.cost_model = cost_model or CostModel()
        # measured (transfer_s, decode_s) per column from the latest run: an
        # alias of the cost model's store (one source of truth)
        self.timings: dict[str, tuple[float, float]] = self.cost_model.measured
        self.cache = ProgramCache()
        self._encoded: dict[str, plan_mod.Encoded] = {}
        self._programs: dict[str, Program] = {}
        self._graphs: dict[str, DecodeGraph] = {}
        # host staging per (column, chunk size, per-chunk?), and the one each
        # column's latest run (or its compile) used
        self._stagings: dict[tuple[str, int | None, bool], StagedColumn] = {}
        self._staged: dict[str, StagedColumn] = {}
        self._schedules: dict[tuple[str, int], ChunkSchedule | None] = {}
        self._copy_stream: torch.cuda.Stream | None = None
        self.last_makespan_s: float | None = None
        # per fused query (signature, chunk size, rows): its operands, row-axis
        # schedule and staging; and its (fused, pre-fusion) traffic
        self._query_runs: dict[tuple, tuple] = {}
        self._query_traffic: dict[str, tuple[int, int]] = {}
        if backend == "kernel" and self.device.type == "cuda":
            # build the four libraries (one nvcc each, at once) and load
            # every kernel on the device now, before any timed run
            libs = (FP_KERNEL, GP_KERNEL, NP_KERNEL, QR_KERNEL)
            cuda.build(libs)
            for lib in libs:
                lib.load(self.device)

    @property
    def _fixed_chunk_bytes(self) -> int | None:
        """The constructor's chunk size as an int or None (``"auto"`` stands for
        the planner's default size where one size is needed)."""
        cb = self.chunk_bytes
        return planner_mod.DEFAULT_CHUNK_BYTES if isinstance(cb, str) else cb

    # ------------------------------------------------------------------ compile
    def compile(self, name: str, enc: plan_mod.Encoded) -> Program:
        """Register a blob: its (cache-shared) Program, its profile in the cost
        model, and its host staging for the constructor's configuration."""
        graph = build_graph(enc)
        prog = self.cache.get(graph, backend=self.backend)
        self._encoded[name] = enc
        self._programs[name] = prog
        # the column's own graph: its group offsets and rANS word counts are
        # data, while the shared program's graph is the first column's
        self._graphs[name] = graph
        # re-registering a name drops whatever was derived from the old blob
        for store in (self._schedules, self._stagings):
            for key in [k for k in store if k[0] == name]:
                store.pop(key)
        self.cost_model.forget(name)
        self.cost_model.register(profile_from(name, enc, graph))
        sched = self.chunk_schedule(name)
        self._staged[name] = self._staging(name, self._fixed_chunk_bytes, sched)
        return prog

    def column_profile(self, name: str):
        """The planner's profile of a registered column."""
        if name not in self.cost_model.profiles:
            self.cost_model.register(profile_from(name, self._encoded[name],
                                                  self._graphs[name]))
        return self.cost_model.profiles[name]

    def program(self, name: str) -> Program:
        return self._programs[name]

    def graph(self, name: str) -> DecodeGraph:
        return self._graphs[name]

    @property
    def copy_stream(self) -> torch.cuda.Stream:
        """The CUDA stream every host->device copy of this executor runs on."""
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._copy_stream

    def _staging(self, name: str, chunk_bytes: int | None,
                 sched: ChunkSchedule | None) -> StagedColumn:
        """The column's host staging for a whole decode with ``chunk_bytes``
        pieces, or for the per-chunk decode of ``sched``; built once each.
        Whole stagings share one host buffer and differ in their copies."""
        pin = self.device.type == "cuda"
        if sched is not None:
            key = (name, chunk_bytes, True)
            if key not in self._stagings:
                self._stagings[key] = stage_column(self._encoded[name], pin, sched)
            return self._stagings[key]
        key = (name, chunk_bytes, False)
        if key not in self._stagings:
            base = self._stagings.get((name, None, False))
            if base is None:
                base = stage_column(self._encoded[name], pin)
                self._stagings[(name, None, False)] = base
            copies = whole_copies(self._encoded[name], base.layout, chunk_bytes)
            self._stagings[key] = dataclasses.replace(base, copies=copies,
                                                      needs=(len(copies),))
        return self._stagings[key]

    # ----------------------------------------------------------------- schedule
    def n_transfer_chunks(self, name: str, chunk_bytes: int | None) -> int:
        """Row-granular pieces a whole-decoded column's leaf buffers move in."""
        if chunk_bytes is None:
            return 1
        return sum(len(split_chunks(np.asarray(v), chunk_bytes))
                   for v in plan_mod.flat_buffers(self._encoded[name]).values())

    def chunk_schedule(self, name: str, chunk_bytes: int | None | object = _DEFAULTS
                       ) -> ChunkSchedule | None:
        """The per-chunk decode schedule of a column at ``chunk_bytes``, or None
        when the graph does not split or one chunk would cover the column.
        Without a size, the constructor's ``chunk_decode`` and ``chunk_bytes``
        decide."""
        if chunk_bytes is self._DEFAULTS:
            if not self.chunk_decode:
                return None
            chunk_bytes = self._fixed_chunk_bytes
        if chunk_bytes is None:
            return None
        key = (name, chunk_bytes)
        if key not in self._schedules:
            self._schedules[key] = self._build_schedule(name, chunk_bytes)
        return self._schedules[key]

    def _build_schedule(self, name: str, chunk_bytes: int) -> ChunkSchedule | None:
        graph = self.graph(name)
        layout = element_chunk_layout(graph)
        if layout is None:
            return self._build_group_schedule(name, chunk_bytes)
        sched = element_schedule(plan_mod.host_operands(self._encoded[name]), layout,
                                 int(graph.n_out), chunk_bytes)
        return None if sched.n_chunks == 1 else sched

    def _build_group_schedule(self, name: str,
                              chunk_bytes: int) -> ChunkSchedule | None:
        """Spans of whole groups of about ``chunk_bytes`` of streamed group
        bytes, on the encoder's group offsets."""
        graph = self.graph(name)
        layout = group_chunk_layout(graph)
        if layout is None:
            return None
        ops = plan_mod.host_operands(self._encoded[name])
        n_groups = int(layout.n_groups)
        bpg = costmodel.group_bytes_per_group(layout, ops)
        if bpg <= 0 or n_groups <= 1:
            return None
        G = costmodel.groups_per_chunk(chunk_bytes, bpg, layout.align_groups)
        if G >= n_groups:
            return None                  # one span would be the whole column
        presum = np.asarray(layout.group_presum, dtype=np.int64)
        g_starts = tuple(range(0, n_groups, G))
        g_sizes = tuple(min(G, n_groups - s) for s in g_starts)
        out_starts = tuple(int(presum[s]) for s in g_starts)
        out_sizes = tuple(int(presum[s + z] - presum[s]) for s, z in zip(g_starts, g_sizes))
        if min(out_sizes) <= 0:
            return None
        if layout.elems_per_group:       # uniform groups: no padding
            pad_sizes = tuple(z * layout.elems_per_group for z in g_sizes)
        else:
            body = [sz for sz, z in zip(out_sizes, g_sizes) if z == G]
            body_pad = costmodel.pad_group_elems(max(body)) if body else 0
            pad_sizes = tuple(body_pad if z == G else costmodel.pad_group_elems(sz)
                              for sz, z in zip(out_sizes, g_sizes))
        slices: dict[str, list[tuple[int, int]]] = {}
        for nm, spec in layout.sliced.items():
            arr = ops[nm]
            axis = layout.axes.get(nm, 0)
            length = int(arr.shape[axis])
            num = int(ops[spec.num_op][0]) if spec.num_op else int(spec.num)
            per = []
            for s, z in zip(g_starts, g_sizes):
                if axis == 1:
                    per.append((s, s + z))          # stripe: exact columns
                    continue
                lo = (s * num) // spec.den
                if s + z >= n_groups:
                    hi = length                      # the rest, guard words too
                elif spec.num_op:
                    # bit-packed words: round the end up and keep the word a
                    # value straddling the boundary reads next
                    hi = min(length, -(-((s + z) * num) // spec.den) + 1)
                else:
                    hi = ((s + z) * num) // spec.den
                per.append((lo, max(hi, lo + 1)))
            slices[nm] = per
        # rANS stripes: span k moves only the rows its own chunks consume
        row_caps: dict[str, tuple[int, ...]] = {}
        gw = self._host_group_words(graph, layout)
        if gw is not None and len(gw) >= n_groups:
            for nm, axis in layout.axes.items():
                if axis != 1 or nm not in layout.sliced:
                    continue
                max_rows = int(np.asarray(ops[nm]).shape[0])
                caps = []
                for s, z in zip(g_starts, g_sizes):
                    need = max(1, int(np.max(gw[s:s + z])))
                    caps.append(min(max_rows, -(-need // ROW_CAP_QUANTUM) * ROW_CAP_QUANTUM))
                row_caps[nm] = tuple(caps)
        return ChunkSchedule(
            out_starts=out_starts, out_sizes=out_sizes, slices=slices,
            whole=layout.whole, kind="group", g_starts=g_starts, g_sizes=g_sizes,
            pad_sizes=pad_sizes, axes=dict(layout.axes), row_caps=row_caps,
            host_push=dict(layout.host_push))

    @staticmethod
    def _host_group_words(graph: DecodeGraph, layout) -> np.ndarray | None:
        """The encoder's per-chunk word counts of an rANS stripe, or None."""
        if layout.kind != "np":
            return None
        gw = graph.stages[layout.stage_index].host_group_words
        return None if gw is None else np.asarray(gw)

    # ------------------------------------------------------------------ planning
    def plan(self, names: Sequence[str] | None = None, policy: str | None = None,
             order: Sequence[str] | None = None,
             chunk_bytes: int | None | str | object = _DEFAULTS,
             chunk_decode: bool | None = None, window: int | None = None,
             fused_columns=None) -> ExecutionPlan:
        """An ``ExecutionPlan`` for registered columns (all by default).

        The constructor's knobs are the defaults and any argument overrides
        them.  An explicit ``order`` pins the issue order (the decisions are
        still planned); ``pipeline=False`` makes the constructor's default
        policy FIFO.  ``fused_columns`` is ``planner.plan_execution``'s."""
        names = list(self._encoded) if names is None else list(names)
        profiles = {n: self.column_profile(n) for n in names}
        pol = policy if policy is not None else (self.policy if self.pipeline else "fifo")
        ep = planner_mod.plan_execution(
            profiles, self.cost_model, policy=pol,
            chunk_bytes=self.chunk_bytes if chunk_bytes is self._DEFAULTS else chunk_bytes,
            chunk_decode=self.chunk_decode if chunk_decode is None else chunk_decode,
            window=self.prefetch_chunks if window is None else window,
            batch_columns=self.batch_columns, fused_columns=fused_columns)
        if order is not None:
            ep = dataclasses.replace(ep, order=tuple(order), policy="explicit")
        return ep

    def issue_order(self, names: Sequence[str] | None = None) -> list[str]:
        """Column issue order under the configured scheduling policy."""
        names = list(self._encoded) if names is None else list(names)
        if not self.pipeline or len(names) <= 1:
            return names
        return list(self.plan(names).order)

    # --------------------------------------------------------------------- run
    def run(self, order: Sequence[str] | None = None, plan: ExecutionPlan | None = None,
            window: int | None = None, names: Sequence[str] | None = None
            ) -> dict[str, ColumnExec]:
        """Transfer + decode the registered columns (all, those of ``names``
        -- the reference's ``run(encs)`` --, or those of ``order``, in that
        order) as ``plan`` decides; without a plan, one is built over them from
        the constructor's knobs.  ``window`` overrides the plan's (decode units
        in flight).  A ``fused`` decision decodes like any other (the flag is
        advisory; ``run_query`` fuses).  Measured actuals feed the cost model
        either way.  Returns per-column records once everything has finished."""
        for given in (order, names):
            unknown = [n for n in given or () if n not in self._encoded]
            if unknown:
                raise KeyError(f"columns not registered: {unknown}")
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        names = list(self._encoded) if names is None else list(names)
        if plan is None:
            plan = self.plan(names, order=order)
        elif order is not None:
            plan = dataclasses.replace(plan, order=tuple(order), policy="explicit")
        missing = [n for n in names if n not in plan.decisions]
        if missing:
            raise ValueError(f"plan does not cover columns {missing}; it was built over "
                             f"{sorted(plan.decisions)}: re-plan after registering them")
        order = [n for n in plan.order if n in names]
        window = plan.window if window is None else window
        cols = {name: self._column(name, plan.decisions[name]) for name in order}
        units = self._units(order, plan.decisions, cols)
        if self.device.type == "cuda":
            res = self._run_cuda(order, units, window, cols)
        else:
            res = self._run_host(order, units, cols)
        for name, rec in res.items():
            self.cost_model.observe(name, rec.transfer_s, rec.decode_s)
        return res

    def _column(self, name: str, d: ColumnDecision) -> dict:
        """A column's state in one run: its decision, schedule and staging."""
        sched = self.chunk_schedule(name, d.chunk_bytes) if d.decode_mode == CHUNK else None
        staged = self._staging(name, d.chunk_bytes, sched)
        self._staged[name] = staged
        return {"decision": d, "sched": sched, "staged": staged}

    def _units(self, order: list[str], decisions, cols: dict) -> list[_Unit]:
        """The run's decode units in order.  Per-chunk columns give one unit per
        chunk; consecutive-in-order columns the plan marked batched decode in
        one unit when they share one Program (adjacent ones only, so transfer
        still overlaps decode; Johnson's rule keys on equal times, so columns
        of one structure end up adjacent anyway)."""
        units: list[_Unit] = []
        for name in order:
            sched = cols[name]["sched"]
            if sched is not None:
                units += [_Unit((name,), k) for k in range(sched.n_chunks)]
                continue
            prev = units[-1].members if units else ()
            if (decisions[name].decode_mode == BATCHED and prev
                    and cols[prev[-1]]["sched"] is None
                    and decisions[prev[-1]].decode_mode == BATCHED
                    and self._programs[prev[-1]] is self._programs[name]):
                units[-1] = _Unit(prev + (name,))
            else:
                units.append(_Unit((name,)))
        return units

    def _decode(self, unit: _Unit, flats: dict[str, torch.Tensor], cols: dict) -> None:
        """Decode one unit from its columns' device buffers ``flats``; ``cols``
        carries each column's output and prologue results between units."""
        name, k = unit.members[0], unit.k
        col = cols[name]
        staged, sched = col["staged"], col["sched"]
        prog = self._programs[name]
        if len(unit.members) > 1:
            out = prog.batched([cols[m]["staged"].views(flats[m]) for m in unit.members])
            for i, m in enumerate(unit.members):
                cols[m]["out"] = out[i]
            return
        if sched is None:
            col["out"] = prog(staged.views(flats[name]))
            return
        graph = self.graph(name)
        bufs = staged.views(flats[name], k)
        if k == 0:
            col["out"] = torch.empty(graph.n_out, dtype=torch_dtype(graph.out_dtype),
                                     device=self.device)
        if sched.kind == "element":
            chunk = self.cache.get_chunk(graph, sched.out_sizes[k], self.backend)
            chunk(bufs, sched.out_starts[k], col["out"])
            return
        if k == 0:
            pro = self.cache.get_group_prologue(graph, self.backend)
            col["resident"] = pro(bufs) if pro is not None else {}
            col["units"] = sched.n_chunks + (pro is not None)
        span = self.cache.get_group_chunk(graph, sched.g_sizes[k], sched.pad_sizes[k],
                                          self.backend)
        span({**bufs, **col["resident"]}, sched.out_starts[k], sched.g_starts[k],
             sched.out_sizes[k], col["out"])

    def _record(self, name: str, col: dict, transfer_s: float, decode_s: float,
                launches: int, batched_with: tuple[str, ...]) -> ColumnExec:
        enc = self._encoded[name]
        sched = col["sched"]
        return ColumnExec(
            name=name, array=col["out"], transfer_s=transfer_s, decode_s=decode_s,
            compressed_bytes=enc.compressed_nbytes, plain_bytes=enc.plain_nbytes,
            n_chunks=(sched.n_chunks if sched is not None
                      else self.n_transfer_chunks(name, col["decision"].chunk_bytes)),
            signature=self._programs[name].signature,
            batched_with=tuple(m for m in batched_with if m != name),
            decode_launches=col.get("units", 1 if sched is None else sched.n_chunks),
            chunk_decoded=sched is not None, kernel_launches=launches)

    def _run_host(self, order: list[str], units: list[_Unit],
                  cols: dict) -> dict[str, ColumnExec]:
        for name in order:
            cols[name].update(transfer=0.0, decode=0.0, launches=0, batch=())
        flats: dict[str, torch.Tensor] = {}
        t_run = time.perf_counter()
        for unit in units:
            t0 = time.perf_counter()
            for name in unit.members:
                staged = cols[name]["staged"]
                if unit.k == 0:
                    flats[name] = torch.empty_like(staged.host, device=self.device)
                first = staged.needs[unit.k - 1] if unit.k else 0
                for a, b in staged.copies[first:staged.needs[unit.k]]:
                    flats[name][a:b].copy_(staged.host[a:b])
            t1 = time.perf_counter()
            before = _launches()
            self._decode(unit, flats, cols)
            t2 = time.perf_counter()
            for name in unit.members:
                col = cols[name]
                col["launches"] += _launches() - before
                col["transfer"] += (t1 - t0) / len(unit.members)
                col["decode"] += (t2 - t1) / len(unit.members)
                col["batch"] = unit.members if len(unit.members) > 1 else ()
        self.last_makespan_s = time.perf_counter() - t_run
        return {name: self._record(name, cols[name], cols[name]["transfer"],
                                   cols[name]["decode"], cols[name]["launches"],
                                   cols[name]["batch"]) for name in order}

    def _run_cuda(self, order: list[str], units: list[_Unit], window: int,
                  cols: dict) -> dict[str, ColumnExec]:
        dev = self.device
        compute = torch.cuda.current_stream(dev)
        copy = self.copy_stream

        def event() -> torch.cuda.Event:
            return torch.cuda.Event(enable_timing=True)

        start, end = event(), event()
        start.record(compute)
        copy.wait_event(start)          # no copy starts before the run does
        flats: dict[str, torch.Tensor] = {}
        landed: list[torch.cuda.Event] = []    # per unit: after its last copy
        decoded: list[torch.cuda.Event] = []   # per unit: after its decode

        def issue(u: int) -> None:
            if u >= window:             # at most `window` units ahead of decode
                copy.wait_event(decoded[u - window])
            unit = units[u]
            with torch.cuda.stream(copy):
                for name in unit.members:
                    staged, col = cols[name]["staged"], cols[name]
                    if unit.k == 0:
                        col["c0"] = event()
                        col["c0"].record(copy)
                        flats[name] = torch.empty(staged.host.numel(), dtype=torch.uint8,
                                                  device=dev)
                    first = staged.needs[unit.k - 1] if unit.k else 0
                    for a, b in staged.copies[first:staged.needs[unit.k]]:
                        flats[name][a:b].copy_(staged.host[a:b], non_blocking=True)
                    col["c1"] = event()
                    col["c1"].record(copy)
                ev = event()
                ev.record(copy)
            landed.append(ev)

        for u in range(min(window, len(units))):
            issue(u)
        for u, unit in enumerate(units):
            compute.wait_event(landed[u])
            for name in unit.members:
                if unit.k == 0:
                    flats[name].record_stream(compute)
                    cols[name]["d0"] = event()
                    cols[name]["d0"].record(compute)
                    cols[name]["launches"] = _launches()
            self._decode(unit, flats, cols)
            d1 = event()
            d1.record(compute)
            decoded.append(d1)
            for name in unit.members:
                col = cols[name]
                if unit.k == len(col["staged"].needs) - 1:
                    col["d1"] = d1
                    col["launches"] = _launches() - col["launches"]
                    col["batch"] = unit.members if len(unit.members) > 1 else ()
                    del flats[name]         # the allocator owns the buffer from here
            if u + window < len(units):
                issue(u + window)
        end.record(compute)
        end.synchronize()
        self.last_makespan_s = start.elapsed_time(end) / 1e3
        # The reference re-times a cold first call so that calibration sees
        # decode, not jit.  Nothing here compiles at a first call, and the
        # module loading that CUDA would otherwise do at a kernel's first
        # launch is done at construction (``KernelLib.load`` with the
        # device), so a cold run's decode times go to ``observe`` as they are.
        return {name: self._record(name, c, c["c0"].elapsed_time(c["c1"]) / 1e3,
                                   c["d0"].elapsed_time(c["d1"]) / 1e3
                                   / max(1, len(c["batch"])), c["launches"], c["batch"])
                for name, c in cols.items()}

    # ------------------------------------------------------------- fused query
    def query_schedule(self, fq, chunk_bytes: int | None) -> ChunkSchedule:
        """The fused query's shared row-axis schedule over its tiled leaves at
        ``chunk_bytes`` (None: one chunk of every row), resolved against the
        query's own operands, as the reference's ``run_query`` addresses them."""
        layout = query_chunk_layout(fq.graph)
        if layout is None:
            raise ValueError(f"graph {fq.graph.nesting!r} is not query-chunkable")
        return element_schedule(fq.operands, layout, fq.n_rows, chunk_bytes)

    def _query_staging(self, fq, chunk_bytes: int | None):
        """Schedule and staging of a query at a chunk size, built once per
        (structure, chunk size, rows) and operand set (a re-lowered query,
        after ``compress``, brings new operands)."""
        key = (fq.graph.signature, chunk_bytes, fq.n_rows)
        hit = self._query_runs.get(key)
        if hit is None or hit[0] is not fq.operands:
            sched = self.query_schedule(fq, chunk_bytes)
            hit = (fq.operands, sched, stage_chunks(fq.operands, sched,
                                                    self.device.type == "cuda"))
            self._query_runs[key] = hit
        return hit[1], hit[2]

    def run_query(self, fq, encs: dict[str, plan_mod.Encoded] | None = None,
                  chunk_bytes: int | None | object = _DEFAULTS,
                  window: int | None = None) -> QueryExec:
        """Execute a decode-fused query (``core.query.lower_query``'s result).

        Resident columns decode first through ``run`` (only they: the
        reference's ``run(encs)``), registered from ``encs`` when they are not
        yet.  Then one shared row-axis schedule streams every fused column's
        leaf slices together, and each chunk is one launch of the query
        kernel -- scan-filter-aggregate fused into the decode -- whose partial
        aggregate is added into one accumulator on the device, in chunk
        order; one copy brings it back.  The accumulator holds one in-flight
        slot, so ``max(1, window - 1)`` chunks are in flight (window 2 by
        default).  The measured selectivity (the count lane) feeds the cost
        model's per-signature EWMA."""
        if chunk_bytes is self._DEFAULTS:
            chunk_bytes = self._fixed_chunk_bytes
        t_start = time.perf_counter()
        start = None
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
        resident_execs: dict[str, ColumnExec] = {}
        res_bufs: dict[str, torch.Tensor] = {}
        if fq.resident:
            missing = [c for c in fq.resident if not encs or c not in encs]
            if missing:
                raise ValueError(f"resident columns need their Encoded blobs: {missing}")
            for c in fq.resident:
                if self._encoded.get(c) is not encs[c]:
                    self.compile(c, encs[c])
            resident_execs = self.run(names=list(fq.resident))
            for c in fq.resident:
                res_bufs[fq.resident_input(c)] = resident_execs[c].array
        sched, staged = self._query_staging(fq, chunk_bytes)
        win = 2 if window is None else max(1, int(window))
        eff = max(1, win - 1)
        acc = torch.empty(fq.graph.n_out, dtype=torch.float32, device=self.device)
        if self.device.type == "cuda":
            transfer_s, decode_s, makespan_s = self._query_cuda(fq, sched, staged, res_bufs,
                                                                eff, acc, start)
        else:
            transfer_s, decode_s = self._query_host(fq, sched, staged, res_bufs, acc)
            makespan_s = time.perf_counter() - t_start
        # The reference re-times a cold first call so that calibration sees the
        # fused decode, not jit.  Nothing here compiles at a first call, and the
        # query kernel is loaded on the card at construction (``KernelLib.load``
        # with the device), so a cold run's times stand as they are.
        acc_np = acc.cpu().numpy()          # the one device-to-host copy
        sel = float(fq.selectivity(acc_np))
        for c in fq.fused_cols:
            if c not in self.cost_model.profiles and encs and c in encs:
                self.cost_model.register(profile_from(c, encs[c], build_graph(encs[c])))
            if c in self.cost_model.profiles:
                self.cost_model.observe_selectivity(c, sel)
        graph, ops = fq.graph, fq.operands
        traffic = self._query_traffic.get(graph.signature)
        if traffic is None:
            all_bufs = {**ops, **res_bufs}
            traffic = (fusion.hbm_traffic_bytes(graph.stages, all_bufs),
                       fusion.hbm_traffic_bytes(fq.prefuse_stages, all_bufs))
            self._query_traffic[graph.signature] = traffic
        compressed = sum(int(np.asarray(ops[b.name]).nbytes) for b in graph.buffers)
        plain = sum(int(encs[c].plain_nbytes) for c in fq.fused_cols) if encs else 0
        return QueryExec(
            name=fq.qplan.name, result=fq.finalize(acc_np), acc=acc,
            transfer_s=transfer_s, decode_s=decode_s, n_chunks=sched.n_chunks,
            decode_launches=sched.n_chunks, selectivity=sel,
            compressed_bytes=compressed, plain_bytes=plain,
            traffic_bytes=traffic[0], prefuse_traffic_bytes=traffic[1],
            resident=resident_execs, makespan_s=makespan_s)

    def _query_launch(self, fq, sched: ChunkSchedule, k: int, bufs: dict,
                      acc: torch.Tensor) -> None:
        prog = self.cache.get_query_chunk(fq.graph, sched.out_sizes[k], self.backend)
        prog(bufs, sched.out_starts[k], out=acc, accumulate=k > 0)

    def _query_host(self, fq, sched, staged, res_bufs, acc) -> tuple[float, float]:
        flat = torch.empty_like(staged.host)
        transfer = decode = 0.0
        for k in range(sched.n_chunks):
            t0 = time.perf_counter()
            first = staged.needs[k - 1] if k else 0
            for a, b in staged.copies[first:staged.needs[k]]:
                flat[a:b].copy_(staged.host[a:b])
            t1 = time.perf_counter()
            self._query_launch(fq, sched, k, {**staged.views(flat, k), **res_bufs}, acc)
            decode += time.perf_counter() - t1
            transfer += t1 - t0
        return transfer, decode

    def _query_cuda(self, fq, sched, staged, res_bufs, eff: int, acc: torch.Tensor,
                    start: torch.cuda.Event) -> tuple[float, float, float]:
        """The chunks' copies on the copy stream, ``eff`` chunks ahead of the
        launches on the compute stream; timed by CUDA events."""
        compute = torch.cuda.current_stream(self.device)
        copy = self.copy_stream

        def event() -> torch.cuda.Event:
            return torch.cuda.Event(enable_timing=True)

        copy.wait_event(start)          # after the resident run, if any
        K = sched.n_chunks
        landed: list[torch.cuda.Event] = []
        decoded: list[torch.cuda.Event] = []
        c0, c1, d0, end = event(), event(), event(), event()
        with torch.cuda.stream(copy):
            flat = torch.empty(staged.host.numel(), dtype=torch.uint8, device=self.device)

        def issue(k: int) -> None:
            if k >= eff:                # at most `eff` chunks ahead of the launches
                copy.wait_event(decoded[k - eff])
            with torch.cuda.stream(copy):
                if k == 0:
                    c0.record(copy)
                first = staged.needs[k - 1] if k else 0
                for a, b in staged.copies[first:staged.needs[k]]:
                    flat[a:b].copy_(staged.host[a:b], non_blocking=True)
                ev = event()
                ev.record(copy)
                if k == K - 1:
                    c1.record(copy)
            landed.append(ev)

        for k in range(min(eff, K)):
            issue(k)
        for k in range(K):
            compute.wait_event(landed[k])
            if k == 0:
                flat.record_stream(compute)
                d0.record(compute)
            self._query_launch(fq, sched, k, {**staged.views(flat, k), **res_bufs}, acc)
            d1 = event()
            d1.record(compute)
            decoded.append(d1)
            if k + eff < K:
                issue(k + eff)
        end.record(compute)
        end.synchronize()
        return (c0.elapsed_time(c1) / 1e3, d0.elapsed_time(end) / 1e3,
                start.elapsed_time(end) / 1e3)
