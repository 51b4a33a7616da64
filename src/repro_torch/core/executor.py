"""Plan-driven streaming decode: whole-column, batched, chunked-transfer and
per-chunk (element or group-span) streaming on one device, and mesh plans
over several.

This is the reference's ``StreamingExecutor``: ``run`` executes an
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
clock.

Transfers and decode are two roles, as in the reference's dispatch engine: an
issuer commits each decode unit's copies (one transfer item per unit) as the
window allows, and the decode driver, a generator, waits for a unit's item and
launches its decode.  ``_InlineIssuer`` issues the copies on the calling thread,
in the order above; with ``async_dispatch`` a ``DispatchEngine`` moves them onto
a transfer thread (``zipflow-xfer``) under a shared host-staging budget.  The
window becomes a host watermark there: the copies of unit u + window are
allowed only once the decode of unit u is recorded, so the copy stream's wait
on that event is never placed before the event exists.

``run_sharded`` executes a ``MeshExecutionPlan`` (``planner.plan_mesh_execution``):
each logical device id's leg -- its whole columns, then its group-span shards --
runs on the physical device ``devices[id % len(devices)]`` (every card for a
CUDA executor; on one card, or on the CPU, every id shares it) with a copy
stream and a compute stream of its own.  A shard decodes the spans of its
group range with the global group and output offsets the kernels check, into
an output of its own size; a redistribution leg copies a decoded shard into
a fresh buffer on its final device.  The legs run one after another, or all
at once: one ``DispatchEngine`` transfer thread a leg, under one
host-staging budget, while the calling thread launches each leg's decodes as
its items land.  Shards are then assembled (``_assemble_shards``).

``run`` also takes the reference's serving hooks: ``preempt`` is called before
every decode unit but the first (a nested ``run`` on the same executor may
cut in there, as ``core/serve_planner.py`` does for point requests), and
``on_ready(name)`` once per column after its last decode is complete on the
device (on a card: its event observed complete).  A column's
``kernel_launches`` counts the launches of its own units, so a nested run
between them is not counted in it.

Under ``torch.profiler`` a run shows its steps as spans (``core/trace.py``):
``repro_torch.run`` and inside it ``run.prepare`` (the columns' state, units
and leg; ``run.stage`` where a staging is built), ``run.issue`` (each commit of
copies), ``run.unit`` (one decode unit, ``run.decode`` its launches) and
``run.sync`` (the host waiting for the device at the end); a ``plan`` that
hands back its last search's plan (``StreamingExecutor.plan``) shows
``plan.reuse`` inside ``repro_torch.plan``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import costmodel, fusion, scheduler
from repro_torch.core import plan as plan_mod
from repro_torch.core import planner as planner_mod
from repro_torch.core.compiler import (Program, ProgramCache, build_graph, device_layout,
                                       fuses)
from repro_torch.core.costmodel import CostModel, profile_from
from repro_torch.core.ir import (DecodeGraph, element_chunk_layout, group_chunk_layout,
                                 query_chunk_layout)
from repro_torch.core.planner import BATCHED, CHUNK, ColumnDecision, ExecutionPlan
from repro_torch.core.trace import span
from repro_torch.kernels import cuda
from repro_torch.kernels.fully_parallel import KERNEL as FP_KERNEL
from repro_torch.kernels.group_parallel import KERNEL as GP_KERNEL
from repro_torch.kernels.non_parallel import KERNEL as NP_KERNEL
from repro_torch.kernels import query_reduce
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
    bit_offsets: dict[str, tuple[int, ...]] = dataclasses.field(default_factory=dict)

    @property
    def n_chunks(self) -> int:
        return len(self.out_starts)

    def piece(self, arr: np.ndarray, leaf: str, k: int) -> np.ndarray:
        """Host slice of ``leaf`` for chunk ``k`` (row-capped for stripes;
        for a bit-packed leaf whose span starts ``bit_offsets`` bits into its
        first word, the words shifted so that the piece starts there)."""
        lo, hi = self.slices[leaf][k]
        if self.axes.get(leaf, 0) == 0:
            r = self.bit_offsets[leaf][k] if leaf in self.bit_offsets else 0
            if r:
                return shift_bits(arr[lo:hi + 1], r)[:hi - lo]
            return arr[lo:hi]
        caps = self.row_caps.get(leaf)
        rows = int(arr.shape[0]) if caps is None else caps[k]
        return np.ascontiguousarray(arr[:rows, lo:hi])


def shift_bits(words: np.ndarray, r: int) -> np.ndarray:
    """uint32 words advanced by ``r`` bits (0 < r < 32): bit b of the result
    is bit b + r of ``words``, zeros past their end."""
    w = words.astype(np.uint64)
    nxt = np.append(w[1:], np.uint64(0))
    return ((w >> np.uint64(r)) | (nxt << np.uint64(32 - r))).astype(np.uint32)


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
    shard_devices: tuple[int, ...] = ()  # mesh run: the final device id of each shard


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


@dataclasses.dataclass(frozen=True)
class ShardedColumn:
    """A column assembled from equal-size group-span shards that sit on
    distinct physical devices: the port's counterpart of the reference's
    sharding-annotated global array (one process cannot make a DTensor over
    several local GPUs: DTensor wants one rank per device).  ``shards`` in
    index order, shard i on ``devices[i]`` from output row ``starts[i]``."""

    shards: tuple[torch.Tensor, ...]
    devices: tuple[torch.device, ...]
    starts: tuple[int, ...]

    def full(self, device=None) -> torch.Tensor:
        """The whole column as one tensor on ``device`` (the first shard's by
        default)."""
        device = self.devices[0] if device is None else torch.device(device)
        return torch.cat([a.to(device) for a in self.shards])


@dataclasses.dataclass
class MeshRunResult:
    """Execution record of one ``run_sharded`` over a device mesh.

    ``columns`` maps every column to its record (a sharded column once,
    assembled); ``per_device`` lists the plan items each logical device id
    executed and ``device_launches`` its decode units; ``d2d_copies`` each
    executed redistribution leg, ``item -> (src device id, dst device id,
    copy seconds)``.  Besides the reference's fields: ``makespan_s``, the run's
    makespan on the device (a CUDA device: by events, from the first leg's
    start to the last leg's or copy's end); ``leg_makespan_s`` each leg's."""

    columns: dict[str, ColumnExec]
    per_device: dict[int, tuple[str, ...]]
    device_launches: dict[int, int]
    plan: "planner_mod.MeshExecutionPlan"
    d2d_copies: dict[str, tuple[int, int, float]] = dataclasses.field(default_factory=dict)
    makespan_s: float = 0.0
    leg_makespan_s: dict[int, float] = dataclasses.field(default_factory=dict)

    def __getitem__(self, name: str) -> ColumnExec:
        return self.columns[name]


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
                 chunk_bytes: int | None = None, clock: dict | None = None) -> StagedColumn:
    """Pack a column for transfer: whole (one copy, or one copy per
    ``split_chunks`` piece of each leaf with the meta operands in one), or per
    chunk of ``sched`` (the whole buffers in one copy, then one per chunk).
    ``clock`` (see ``_pack``) accumulates the allocation and the packing."""
    ops = plan_mod.host_operands(enc)
    leaves = plan_mod.flat_buffers(enc)
    if sched is not None:
        return stage_chunks(ops, sched, pin, clock)
    names = [k for k in ops if k not in leaves] + list(leaves)   # meta first
    arrays = [(k, device_layout(ops[k])) for k in names]
    layout, end = _place(arrays, 0)
    copies = list(whole_copies(enc, layout, chunk_bytes))
    return _pack(arrays, layout, end, copies, (len(copies),), (), pin, clock)


def stage_chunks(ops: dict[str, np.ndarray], sched: ChunkSchedule,
                 pin: bool = False, clock: dict | None = None) -> StagedColumn:
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
    return _pack(arrays, layout, end, copies, tuple(needs), tuple(pieces), pin, clock)


def _pack(arrays, layout, end: int, copies, needs, pieces, pin: bool,
          clock: dict | None = None) -> StagedColumn:
    """The host buffer (page-locked with ``pin``) with every array copied in;
    ``clock`` accumulates the host seconds of the allocation (``"alloc"``)
    and of the copies into it (``"pack"``)."""
    t0 = time.perf_counter()
    host = torch.empty(max(end, 1), dtype=torch.uint8, pin_memory=pin)
    t1 = time.perf_counter()
    for (_, o, nb, _, _), (_, a) in zip(list(layout) + [e for p in pieces for e in p],
                                        arrays):
        host[o:o + nb].copy_(torch.from_numpy(a.reshape(-1).view(np.uint8)))
    if clock is not None:
        clock["alloc"] += t1 - t0
        clock["pack"] += time.perf_counter() - t1
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


# ----------------------------------------------------------- dispatch engine
#
# The two roles of the module docstring: an issuer commits transfer items (one
# per decode unit) up to the watermark the dispatcher advances, and the decode
# driver (``_Leg.decode``) yields ``("need", n)`` before it touches items < n.
# Workers never compile: an item only copies and records events, and every
# ProgramCache lookup, kernel build and load and query build stays on the
# dispatcher thread (the three decode libraries are built and loaded on the
# device at the executor's construction, and on another card when a leg is
# placed there; a query's kernel at ``prepare_query``).


class _InlineIssuer:
    """Synchronous issuer: ``advance(target)`` commits items < target on the
    calling thread.  ``issue_s`` is the host time its commits took."""

    def __init__(self, issue, total: int):
        self._issue = issue
        self.total = total
        self.committed = 0
        self.issue_s = 0.0

    def advance(self, target: int) -> None:
        target = min(target, self.total)
        if self.committed >= target:
            return
        t0 = time.perf_counter()
        with span("run.issue"):
            while self.committed < target:
                self._issue(self.committed)
                self.committed += 1
        self.issue_s += time.perf_counter() - t0


class _WorkerIssuer:
    """One transfer thread for one link.

    The dispatcher advances an item watermark (``advance``); the worker
    commits the allowed items strictly in order, acquiring one shared
    host-staging slot for each item ``held`` marks (a chunk of a
    per-chunk-decode column; whole columns hold none).  The dispatcher
    releases those slots as it consumes the items (``consumed``, once the
    unit's decode is launched).  A worker's exception surfaces as
    ``RuntimeError("transfer worker failed")`` when the dispatcher next waits
    for a commit (``check_error``, ``wait``).  ``issue_s`` is the host time
    the worker's commits took; with ``sync`` (a device-to-device leg) an
    item's ``issue`` returns what to block on (a CUDA event, or None when the
    copy is already done), and ``issue_s`` is the blocking copy's duration."""

    def __init__(self, issue, total: int, held: Sequence[bool] | None = None,
                 budget: threading.BoundedSemaphore | None = None,
                 cv: threading.Condition | None = None, name: str = "zipflow-xfer",
                 sync: bool = False):
        self._issue = issue
        self.total = total
        self.committed = 0
        self._allowed = 0
        self._held = held if budget is not None else None
        self._budget = budget
        self._sync = sync
        self._rel_ptr = 0
        self._stop = False
        self.issue_s = 0.0
        self.error: BaseException | None = None
        self._cv = cv if cv is not None else threading.Condition()
        self._thread = threading.Thread(target=self._work, name=name, daemon=True)
        self._thread.start()

    # ----- worker side
    def _work(self) -> None:
        try:
            i = 0
            while i < self.total:
                with self._cv:
                    while self._allowed <= i and not self._stop:
                        self._cv.wait()
                    if self._stop:
                        return
                    hi = min(self._allowed, self.total)
                while i < hi:
                    if self._held is not None and self._held[i]:
                        # one slot per transferred-but-undecoded chunk
                        while not self._budget.acquire(timeout=0.1):
                            if self._stop:
                                return
                    t0 = time.perf_counter()
                    done = self._issue(i)
                    if self._sync and done is not None:
                        done.synchronize()
                    self.issue_s += time.perf_counter() - t0
                    with self._cv:
                        self.committed = i + 1
                        self._cv.notify_all()
                    i += 1
        except BaseException as e:          # surfaced when the dispatcher next waits
            with self._cv:
                self.error = e
                self._cv.notify_all()

    # ----- dispatcher side
    def advance(self, target: int) -> None:
        target = min(target, self.total)
        with self._cv:
            if target > self._allowed:
                self._allowed = target
                self._cv.notify_all()

    def check_error(self) -> None:
        if self.error is not None:
            raise RuntimeError("transfer worker failed") from self.error

    def wait(self, target: int) -> None:
        """Block until the items < target are committed, or raise the
        worker's exception."""
        target = min(target, self.total)
        with self._cv:
            while self.committed < target and self.error is None:
                self._cv.wait(timeout=0.05)
        self.check_error()

    def consumed(self, upto: int) -> None:
        """The dispatcher consumed items < upto: release their staging slots."""
        if self._held is None:
            return
        upto = min(upto, self.total)
        while self._rel_ptr < upto:
            if self._held[self._rel_ptr]:
                self._budget.release()
            self._rel_ptr += 1

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30.0)


class DispatchEngine:
    """Transfer threads, one a link, and the decode dispatcher (the calling
    thread).

    ``issuer`` starts a ``_WorkerIssuer`` bound to the engine's condition (so
    any link's commit wakes the dispatcher) and its host-staging budget
    (``LinkTopology.host_window`` slots, shared by every link; None:
    unbounded).  ``drive`` round-robins the decode drivers of several legs on
    the calling thread: a leg resumes as soon as its pending ``("need", n)``
    is committed, so one leg's decode launches interleave with another's
    while every link's worker keeps its copies going.  A need for item n
    also says that the leg's items before n - 1 are decoded, so their slots
    are released first, and a finished leg releases the rest.  Liveness: a
    leg's needs come in item order and a slot is released as its chunk is
    consumed, so every held slot belongs to a chunk some leg consumes
    without further budget.  Any worker's error, a leg's or a D2D issuer's,
    surfaces at the dispatcher's next step.  ``wait_s`` is the host time the dispatcher spent
    blocked with no leg able to go on."""

    def __init__(self, host_window: int | None = None):
        self._cv = threading.Condition()
        self.wait_s = 0.0
        self._budget = (None if host_window is None
                        else threading.BoundedSemaphore(max(1, host_window)))
        self._issuers: list[_WorkerIssuer] = []

    def issuer(self, issue, total: int, held: Sequence[bool] | None = None,
               name: str = "zipflow-xfer", sync: bool = False) -> _WorkerIssuer:
        iss = _WorkerIssuer(issue, total, held=held, budget=self._budget, cv=self._cv,
                            name=name, sync=sync)
        self._issuers.append(iss)
        return iss

    def drive(self, tasks: dict) -> dict:
        """``tasks``: key -> (decode-driver generator, its issuer from
        ``issuer``).  Runs every generator to its end; returns key -> its
        value."""
        results: dict = {}
        live = dict(tasks)
        need: dict = dict.fromkeys(tasks)       # None: not started
        while live:
            self._check_errors()
            progressed = False
            for key in list(live):
                gen, iss = live[key]
                if need[key] is not None and iss.committed < need[key]:
                    continue
                try:
                    _, n = gen.send(None)
                except StopIteration as stop:
                    results[key] = stop.value
                    iss.consumed(iss.total)
                    del live[key]
                else:
                    iss.consumed(n - 1)
                    need[key] = min(n, iss.total)
                progressed = True
            if live and not progressed:
                t0 = time.perf_counter()
                with self._cv:
                    while not (any(iss.error is not None for iss in self._issuers)
                               or any(iss.committed >= need[k]
                                      for k, (_, iss) in live.items())):
                        self._cv.wait(timeout=0.05)
                self.wait_s += time.perf_counter() - t0
        return results

    def _check_errors(self) -> None:
        for iss in self._issuers:
            iss.check_error()

    def close(self) -> None:
        for iss in self._issuers:
            iss.close()


def _drive_seq(gen):
    """Drive one decode-driver generator to its end on the calling thread, with
    an ``_InlineIssuer``: its ``advance`` has committed every item the
    generator needs before it asks."""
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


def _event() -> torch.cuda.Event:
    return torch.cuda.Event(enable_timing=True)


@dataclasses.dataclass(frozen=True)
class _Place:
    """Where one leg runs: its physical device and, on a CUDA device, the
    streams of its copies and of its decode (None: the executor's copy
    stream and the caller's current stream)."""

    device: torch.device
    copy: "torch.cuda.Stream | None" = None
    compute: "torch.cuda.Stream | None" = None


class _Leg:
    """One run's decode units on one device.

    ``issue(u)`` is unit u's transfer item: it copies the unit's operands
    into its columns' device buffers and stores what landed in ``slots[u]``,
    written once by whichever thread issues and read by the dispatcher only
    after the item is committed.  ``decode`` is the dispatcher's generator.
    The copy side keeps its own per-column buffers (``bufs``) and the
    dispatcher its own (``flats``); no dict is mutated by both.  An item of
    ``cols`` with a ``"column"`` is a group-span shard of that column: it is
    not reported to ``on_ready``; ``on_shard(item, state)`` is called once
    its last span is launched instead."""

    def __init__(self, ex: "StreamingExecutor", units: list[_Unit], window: int, cols: dict,
                 place: _Place | None = None):
        self.ex, self.units, self.window, self.cols = ex, units, window, cols
        self.device = ex.device if place is None else place.device
        self.slots: list = [None] * len(units)
        self.bufs: dict[str, torch.Tensor] = {}
        self.last = {m: u for u, unit in enumerate(units) for m in unit.members}
        self.done: list[str] = []       # columns decoded, not yet reported ready
        self.makespan_s = 0.0
        for c in cols.values():
            c.update(launches=0, batch=(), device=self.device)

    def budget_flags(self) -> list[bool]:
        """Per item: whether it holds a host-staging slot (a chunk of a
        per-chunk-decode column)."""
        return [self.cols[unit.members[0]]["sched"] is not None for unit in self.units]

    def _copy_ranges(self, name: str, k: int):
        staged = self.cols[name]["staged"]
        first = staged.needs[k - 1] if k else 0
        return staged, staged.copies[first:staged.needs[k]]

    def compute_stream(self):
        return contextlib.nullcontext()

    def decode(self, issuer, preempt=None, on_ready=None, on_shard=None, defer: bool = False):
        """The decode driver; returns the records, or None with ``defer``
        (the caller collects them with ``finish`` once every leg is driven)."""
        self.begin()
        issuer.advance(self.window)
        flats: dict[str, torch.Tensor] = {}
        for u, unit in enumerate(self.units):
            if preempt is not None and u:
                preempt()               # a unit boundary: urgent work may cut in
            yield ("need", u + 1)
            with span("run.unit"):
                # no reference to the unit's buffers outlives ``flats``: the last
                # unit of a column frees its buffer right after its decode
                self.land(unit, self.slots[u], flats)
                self.slots[u] = None
                before = _launches()    # this unit's launches only, not a nested run's
                with self.compute_stream(), span("run.decode"):
                    self.ex._decode(unit, flats, self.cols)
                launched = _launches() - before
                self.decoded(u, unit)
            for name in unit.members:
                col = self.cols[name]
                col["launches"] += launched
                if u == self.last[name]:
                    col["batch"] = unit.members if len(unit.members) > 1 else ()
                    del flats[name]     # the allocator owns the buffer from here
                    if "column" not in col:
                        self.done.append(name)
                    elif on_shard is not None:
                        on_shard(name, col)
            issuer.advance(u + self.window + 1)
            if on_ready is not None:
                self.report(on_ready, block=False)
        self.stop()
        return None if defer else self.finish(on_ready)

    def finish(self, on_ready) -> dict[str, ColumnExec]:
        """Wait for the leg's work (``on_ready`` for the columns not yet
        reported), then its records."""
        with span("run.sync"):
            self.wait(on_ready)
        return self.records()


class _CudaLeg(_Leg):
    """Copies on a copy stream, decode on a compute stream (by default the
    executor's copy stream and the caller's current stream; a mesh leg's own
    pair), every span timed by CUDA events; one synchronize at the end."""

    def __init__(self, ex, units, window, cols, place: _Place | None = None):
        super().__init__(ex, units, window, cols, place)
        self.caller = torch.cuda.current_stream(self.device)
        self.own = place is not None and place.compute is not None
        self.compute = place.compute if self.own else self.caller
        self.copy = place.copy if place is not None and place.copy is not None \
            else ex.copy_stream
        self.decoded_ev: list[torch.cuda.Event] = []   # per unit: after its decode

    def compute_stream(self):
        return torch.cuda.stream(self.compute) if self.own else contextlib.nullcontext()

    def begin(self) -> None:
        self.start, self.end = _event(), _event()
        if self.own:
            self.compute.wait_stream(self.caller)  # after the caller's earlier work
        self.start.record(self.compute)
        self.copy.wait_event(self.start)       # no copy starts before the run does

    def issue(self, u: int) -> None:
        copy, unit = self.copy, self.units[u]
        if u >= self.window:
            # at most `window` units ahead of decode; the issuer allows item u
            # only after the decode of unit u - window is recorded
            copy.wait_event(self.decoded_ev[u - self.window])
        landed = {}
        with torch.cuda.stream(copy):
            for name in unit.members:
                staged, ranges = self._copy_ranges(name, unit.k)
                c0 = None
                if unit.k == 0:
                    c0 = _event()
                    c0.record(copy)
                    self.bufs[name] = torch.empty(staged.host.numel(), dtype=torch.uint8,
                                                  device=self.device)
                flat = self.bufs[name]
                for a, b in ranges:
                    flat[a:b].copy_(staged.host[a:b], non_blocking=True)
                c1 = _event()
                c1.record(copy)
                landed[name] = (flat if unit.k == 0 else None, c0, c1)
                if u == self.last[name]:
                    del self.bufs[name]
            ev = _event()
            ev.record(copy)
        self.slots[u] = (landed, ev)

    def land(self, unit: _Unit, landed, flats: dict) -> None:
        per, ev = landed
        self.compute.wait_event(ev)
        for name, (flat, c0, c1) in per.items():
            col = self.cols[name]
            if flat is not None:
                flat.record_stream(self.compute)
                flats[name] = flat
                col["c0"] = c0
                col["d0"] = _event()
                col["d0"].record(self.compute)
            col["c1"] = c1

    def decoded(self, u: int, unit: _Unit) -> None:
        d1 = _event()
        d1.record(self.compute)
        self.decoded_ev.append(d1)
        for name in unit.members:
            if u == self.last[name]:
                self.cols[name]["d1"] = d1

    def report(self, on_ready, block: bool) -> None:
        """``on_ready`` for the decoded columns whose last decode is complete,
        in decode order (the stream completes them in that order); with
        ``block``, waiting for each."""
        while self.done:
            d1 = self.cols[self.done[0]]["d1"]
            if block:
                d1.synchronize()
            elif not d1.query():
                return
            on_ready(self.done.pop(0))

    def stop(self) -> None:
        self.end.record(self.compute)

    def wait(self, on_ready) -> None:
        if on_ready is not None:
            self.report(on_ready, block=True)
        self.end.synchronize()

    def records(self) -> dict[str, ColumnExec]:
        ex = self.ex
        self.makespan_s = ex.last_makespan_s = self.start.elapsed_time(self.end) / 1e3
        if self.own:
            # the outputs were made on the leg's stream; the caller uses them on its own
            for c in self.cols.values():
                c["out"].record_stream(self.caller)
        # The reference re-times a cold first call so that calibration sees
        # decode, not jit.  Nothing here compiles at a first call, and the
        # module loading that CUDA would otherwise do at a kernel's first
        # launch is done at construction (``KernelLib.load`` with the
        # device), so a cold run's decode times go to ``observe`` as they are.
        return {name: ex._record(name, c, c["c0"].elapsed_time(c["c1"]) / 1e3,
                                 c["d0"].elapsed_time(c["d1"]) / 1e3
                                 / max(1, len(c["batch"])), c["launches"], c["batch"])
                for name, c in self.cols.items()}


class _HostLeg(_Leg):
    """The same units on the CPU: copies and decode timed by the host clock,
    a batch's times split evenly among its columns."""

    def __init__(self, ex, units, window, cols, place: _Place | None = None):
        super().__init__(ex, units, window, cols, place)
        for c in cols.values():
            c.update(transfer=0.0, decode=0.0)

    def begin(self) -> None:
        self.t_run = time.perf_counter()

    def issue(self, u: int) -> None:
        unit = self.units[u]
        t0 = time.perf_counter()
        landed = {}
        for name in unit.members:
            staged, ranges = self._copy_ranges(name, unit.k)
            if unit.k == 0:
                self.bufs[name] = torch.empty_like(staged.host, device=self.device)
            flat = self.bufs[name]
            for a, b in ranges:
                flat[a:b].copy_(staged.host[a:b])
            landed[name] = flat if unit.k == 0 else None
            if u == self.last[name]:
                del self.bufs[name]
        self.slots[u] = (landed, (time.perf_counter() - t0) / len(unit.members))

    def land(self, unit: _Unit, landed, flats: dict) -> None:
        per, transfer = landed
        for name, flat in per.items():
            if flat is not None:
                flats[name] = flat
        for name in unit.members:
            self.cols[name]["transfer"] += transfer
        self.t1 = time.perf_counter()

    def decoded(self, u: int, unit: _Unit) -> None:
        dt = (time.perf_counter() - self.t1) / len(unit.members)
        for name in unit.members:
            self.cols[name]["decode"] += dt

    def report(self, on_ready, block: bool) -> None:
        while self.done:
            on_ready(self.done.pop(0))

    def stop(self) -> None:
        self.t_end = time.perf_counter()

    def wait(self, on_ready) -> None:
        if on_ready is not None:
            self.report(on_ready, block=True)

    def records(self) -> dict[str, ColumnExec]:
        ex = self.ex
        self.makespan_s = ex.last_makespan_s = self.t_end - self.t_run
        return {name: ex._record(name, c, c["transfer"], c["decode"], c["launches"],
                                 c["batch"]) for name, c in self.cols.items()}


@dataclasses.dataclass
class _D2DLeg:
    """One redistribution leg of a mesh run: a decoded shard (``src``, whose
    decode ends at event ``after`` on a card) copied to its final device id;
    ``out`` the copy, ``seconds`` its time (events on a card, ``c0`` to
    ``c1``; the host clock on the CPU, ending at ``t_end``)."""

    src_id: int
    dst_id: int
    device: torch.device
    src: torch.Tensor | None = None
    after: "torch.cuda.Event | None" = None
    out: torch.Tensor | None = None
    seconds: float = 0.0
    c0: "torch.cuda.Event | None" = None
    c1: "torch.cuda.Event | None" = None
    t_end: float = 0.0
    iss: "_WorkerIssuer | None" = None


def _own_copy(ep: ExecutionPlan) -> ExecutionPlan:
    """``ep`` with dicts of its own, so that no caller changes a stored plan."""
    return dataclasses.replace(ep, decisions=dict(ep.decisions), baselines=dict(ep.baselines))


def _within(snap: tuple, times: tuple[float, ...], decode_scale: float) -> bool:
    """Both relative distances of the priced inputs from ``snap`` (its
    ``(times, decode_scale)``) under ``planner.REPLAN_DRIFT``: the L1 distance
    of the per-column times over their sum, and ``decode_scale``'s."""
    was, scale = snap
    moved = sum(abs(a - b) for a, b in zip(times, was))
    return (moved == 0 or moved < planner_mod.REPLAN_DRIFT * sum(was)) and \
        abs(decode_scale - scale) < planner_mod.REPLAN_DRIFT * scale


@dataclasses.dataclass(frozen=True)
class _PlanMemo:
    """``StreamingExecutor.plan``'s last search: its key (the resolved knobs,
    the column names and whether the cost model is calibrated), the columns'
    registered profiles and the cost model it read (held, so that identity
    decides), its plan, and two snapshots of the priced inputs, each a
    ``(times, decode_scale)``: what the search priced, and what the plan
    measured in its first run (``own``, taken by the first call after it)."""

    key: tuple
    profiles: tuple
    cost_model: CostModel
    plan: ExecutionPlan
    priced: tuple                   # (per column transfer_s + decode_s, decode_scale)
    observed: int                   # the cost model's observations at the search
    own: tuple | None = None

    def matches(self, key: tuple, profiles: tuple, cost_model: CostModel) -> bool:
        return (key == self.key and cost_model is self.cost_model
                and all(a is b for a, b in zip(profiles, self.profiles)))


class StreamingExecutor:
    """Plan-driven streaming decode over cached programs.

    ``chunk_bytes`` (an int, None for whole-blob transfer, or ``"auto"`` for
    per-column sizing), ``chunk_decode``, ``policy``, ``pipeline``,
    ``batch_columns`` and ``prefetch_chunks`` (the window) are planner
    defaults, as in the reference: they parameterize the ``ExecutionPlan``
    built when ``run`` is called without one; a plan passed in is
    authoritative.  ``async_dispatch`` makes ``run`` issue its copies from a
    ``DispatchEngine`` transfer thread by default (off, as in the
    reference).  ``fuse=False`` compiles the columns' unfused graphs (the
    ``"baseline"`` backend never fuses).  ``cache`` is the ``ProgramCache``
    to share (a fresh one by default)."""

    _DEFAULTS = object()     # "use the constructor's chunk configuration"

    def __init__(self, backend: str, device: torch.device | str,
                 chunk_bytes: int | None | str = 1 << 20, chunk_decode: bool = False,
                 policy: str = "chunk-johnson", pipeline: bool = True,
                 batch_columns: bool = True, prefetch_chunks: int | None = None,
                 cost_model: CostModel | None = None, async_dispatch: bool = False,
                 fuse: bool = True, cache: ProgramCache | None = None):
        self.backend = backend
        self.fuse = fuse
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.chunk_bytes = chunk_bytes
        self.chunk_decode = chunk_decode
        self.policy = policy
        self.pipeline = pipeline
        self.batch_columns = batch_columns
        self.async_dispatch = async_dispatch
        self.prefetch_chunks = None if prefetch_chunks is None else max(1, prefetch_chunks)
        self.cost_model = cost_model or CostModel()
        # measured (transfer_s, decode_s) per column from the latest run: an
        # alias of the cost model's store (one source of truth)
        self.timings: dict[str, tuple[float, float]] = self.cost_model.measured
        self.cache = cache if cache is not None else ProgramCache()
        self._encoded: dict[str, plan_mod.Encoded] = {}
        self._programs: dict[str, Program] = {}
        self._graphs: dict[str, DecodeGraph] = {}
        # host staging per (column, chunk size, per-chunk?), and the one each
        # column's latest run (or its compile) used
        self._stagings: dict[tuple[str, int | None, bool], StagedColumn] = {}
        self._staged: dict[str, StagedColumn] = {}
        self._schedules: dict[tuple[str, int], ChunkSchedule | None] = {}
        self._copy_stream: torch.cuda.Stream | None = None
        # a mesh leg's own (copy, compute) streams, per logical and physical
        # device; a D2D copy's stream per device
        self._leg_streams: dict[tuple, tuple[torch.cuda.Stream, torch.cuda.Stream]] = {}
        self._d2d_streams: dict[torch.device, torch.cuda.Stream] = {}
        # cumulative host seconds of ``compile`` by part: the graph and its
        # program, the cost-model profile, the chunk schedule, the staging's
        # layout; and of every staging's allocation and packing (at a compile
        # or a run that needs a new one)
        self.register_split_s = dict.fromkeys(
            ("program", "profile", "schedule", "layout", "alloc", "pack"), 0.0)
        # cumulative count of the stagings ``_staging`` has built (each a host
        # allocation and a pack of the column's operands), at a compile or a run
        self.stagings_built = 0
        # ``plan``'s one-entry memo, and its cumulative searches and reuses
        self._plan_memo: _PlanMemo | None = None
        self.plans_built = 0
        self.plans_reused = 0
        self.last_makespan_s: float | None = None
        # host seconds of the last run's copy issue (on whichever thread
        # issued) and of its dispatcher's waits for the transfer thread (0.0
        # inline)
        self.last_issue_s: float | None = None
        self.last_wait_s: float | None = None
        # per fused query (signature, chunk size, rows): its operands, row-axis
        # schedule and staging; and its (fused, pre-fusion) traffic
        self._query_runs: dict[tuple, tuple] = {}
        self._prepared: dict[int, object] = {}   # the Reduces whose kernel is loaded
        self._query_traffic: dict[str, tuple[int, int]] = {}
        if backend in ("kernel", "baseline") and self.device.type == "cuda":
            # build the three decode libraries (one nvcc each, at once) and
            # load every kernel on the device now, before any timed run; a
            # query's kernel is built when the query is prepared
            libs = (FP_KERNEL, GP_KERNEL, NP_KERNEL)
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
        split = self.register_split_s
        t0 = time.perf_counter()
        graph = build_graph(enc, fuse=fuses(self.backend, self.fuse))
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
        t1 = time.perf_counter()
        self.cost_model.forget(name)
        self.cost_model.register(profile_from(name, enc, graph))
        t2 = time.perf_counter()
        sched = self.chunk_schedule(name)
        t3 = time.perf_counter()
        packed = split["alloc"] + split["pack"]
        self._staged[name] = self._staging(name, self._fixed_chunk_bytes, sched)
        t4 = time.perf_counter()
        split["program"] += t1 - t0
        split["profile"] += t2 - t1
        split["schedule"] += t3 - t2
        split["layout"] += t4 - t3 - (split["alloc"] + split["pack"] - packed)
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
        if sched is not None:
            key = (name, chunk_bytes, True)
            if key not in self._stagings:
                self._stagings[key] = self._stage(name, sched)
            return self._stagings[key]
        key = (name, chunk_bytes, False)
        if key not in self._stagings:
            base = self._stagings.get((name, None, False))
            if base is None:
                base = self._stagings[(name, None, False)] = self._stage(name, None)
            copies = whole_copies(self._encoded[name], base.layout, chunk_bytes)
            self._stagings[key] = dataclasses.replace(base, copies=copies,
                                                      needs=(len(copies),))
        return self._stagings[key]

    def _stage(self, name: str, sched: ChunkSchedule | None) -> StagedColumn:
        """Build one staging of a column (page-locked on a card), counted."""
        with span("run.stage"):
            staged = stage_column(self._encoded[name], self.device.type == "cuda", sched,
                                  clock=self.register_split_s)
        self.stagings_built += 1
        return staged

    # ----------------------------------------------------------------- schedule
    def n_transfer_chunks(self, name: str, chunk_bytes: int | None) -> int:
        """Row-granular pieces a whole-decoded column's leaf buffers move in."""
        if chunk_bytes is None:
            return 1
        return sum(len(split_chunks(np.asarray(v), chunk_bytes))
                   for v in plan_mod.flat_buffers(self._encoded[name]).values())

    # ------------------------------------------------------------------- model
    def measured_jobs(self, names: Sequence[str] | None = None) -> list[scheduler.Job]:
        """Scheduling jobs from the cost model in consistent units: measured
        times when every column has one, calibrated chip estimates for all
        otherwise (``CostModel.jobs``)."""
        names = list(self._encoded) if names is None else list(names)
        return self.cost_model.jobs(names)

    def modeled_makespan(self, names: Sequence[str] | None = None, pipeline: bool = True,
                         johnson: bool = True, chunked: bool = False) -> float:
        """Two-machine flow-shop makespan from the current (measured or
        estimated) per-column times, at the transfer chunks of the
        constructor's size when ``chunked``; ``pipeline=False`` is the serial
        time."""
        jobs = self.measured_jobs(names)
        if not pipeline:
            return scheduler.serial_time(jobs)
        if chunked:
            jobs = scheduler.chunk_jobs(jobs, [
                self.n_transfer_chunks(j.name, self._fixed_chunk_bytes) for j in jobs])
        order = scheduler.johnson_order(jobs) if johnson else scheduler.fifo_order(jobs)
        return scheduler.makespan(jobs, order)

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

    def _build_group_schedule(self, name: str, chunk_bytes: int, g_lo: int = 0,
                              g_hi: int | None = None,
                              force: bool = False) -> ChunkSchedule | None:
        """Spans of whole groups of about ``chunk_bytes`` of streamed group
        bytes, on the encoder's group offsets.  ``g_lo``/``g_hi`` restrict it
        to a group range (a mesh shard), with ``g_starts``/``out_starts``
        still global; ``force`` gives a schedule even when one span covers
        the range (a shard needs one; a whole column then does not split)."""
        graph = self.graph(name)
        layout = group_chunk_layout(graph)
        if layout is None:
            return None
        ops = plan_mod.host_operands(self._encoded[name])
        n_groups = int(layout.n_groups)
        g_hi = n_groups if g_hi is None else min(int(g_hi), n_groups)
        g_lo = max(0, int(g_lo))
        span_groups = g_hi - g_lo
        bpg = costmodel.group_bytes_per_group(layout, ops)
        if span_groups < 1 or (bpg <= 0 and not force) or (n_groups <= 1 and not force):
            return None
        G = costmodel.groups_per_chunk(chunk_bytes, max(bpg, 1e-9), layout.align_groups)
        if G >= span_groups and not force:
            return None                  # one span would be the whole column
        G = max(1, min(G, span_groups))
        presum = np.asarray(layout.group_presum, dtype=np.int64)
        g_starts = tuple(range(g_lo, g_hi, G))
        g_sizes = tuple(min(G, g_hi - s) for s in g_starts)
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
        bit_offsets: dict[str, tuple[int, ...]] = {}
        for nm, spec in layout.sliced.items():
            arr = ops[nm]
            axis = layout.axes.get(nm, 0)
            length = int(arr.shape[axis])
            num = int(ops[spec.num_op][0]) if spec.num_op else int(spec.num)
            if axis == 0 and any(s * num % spec.den for s in g_starts):
                # a shard's first group need not start a word: the kernels
                # read a span's slice from its first element, so a bit-packed
                # leaf's pieces start at the span's first bit
                if not (spec.num_op and spec.den == 32 and arr.dtype == np.uint32):
                    raise ValueError(f"{name}: a span of {nm!r} starts inside an item")
                bit_offsets[nm] = tuple(s * num % 32 for s in g_starts)
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
        if gw is not None and len(gw) >= g_hi:
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
            host_push=dict(layout.host_push), bit_offsets=bit_offsets)

    def shard_schedule(self, name: str, chunk_bytes: int | None, g_lo: int,
                       g_hi: int) -> ChunkSchedule | None:
        """The group-span schedule of a column restricted to ``[g_lo, g_hi)``
        (a mesh shard; None chunk size: the planner's default), built once
        per range: always one for a group-chunkable column, None otherwise."""
        key = (name, chunk_bytes, (int(g_lo), int(g_hi)))
        if key not in self._schedules:
            cb = planner_mod.DEFAULT_CHUNK_BYTES if chunk_bytes is None else chunk_bytes
            self._schedules[key] = self._build_group_schedule(name, cb, g_lo, g_hi,
                                                              force=True)
        return self._schedules[key]

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
        policy FIFO.  ``fused_columns`` is ``planner.plan_execution``'s.

        The last search is kept: a call with the same columns (the same
        registered profiles: a re-``compile`` or a ``forget`` searches anew),
        the same cost model (calibrated or not), knobs and fused columns (with
        their resolved selectivities) gets a copy of its plan while the priced
        inputs -- each column's predicted transfer + decode time, and the cost
        model's ``decode_scale`` -- stay within ``planner.REPLAN_DRIFT`` of
        what the search priced or of what the plan measured in its first run,
        whose timings follow the plan's own chunkings (span ``plan.reuse``,
        count ``plans_reused``); otherwise it searches again (count
        ``plans_built``)."""
        with span("plan"):
            names = list(self._encoded) if names is None else list(names)
            profiles = {n: self.column_profile(n) for n in names}
            profs = tuple(profiles.values())
            cm = self.cost_model
            pol = policy if policy is not None else (self.policy if self.pipeline else "fifo")
            cb = self.chunk_bytes if chunk_bytes is self._DEFAULTS else chunk_bytes
            cd = self.chunk_decode if chunk_decode is None else chunk_decode
            win = self.prefetch_chunks if window is None else window
            fused = None if fused_columns is None else tuple(sorted(
                (n, cm.selectivity_for(n) if s is None else float(s))
                for n, s in fused_columns.items()))
            key = (tuple(names), pol, cb, cd, win, self.batch_columns, fused, cm.n_observed > 0)
            times = tuple(j.transfer_s + j.decompress_s for j in cm.jobs(names))
            scale = cm.decode_scale
            memo = self._plan_memo
            hit = memo is not None and memo.matches(key, profs, cm)
            if hit and memo.own is None and cm.n_observed > memo.observed:
                memo = self._plan_memo = dataclasses.replace(memo, own=(times, scale))
            if hit and any(_within(snap, times, scale)
                           for snap in (memo.priced, memo.own) if snap is not None):
                with span("plan.reuse"):
                    ep = _own_copy(memo.plan)
                    self.plans_reused += 1
            else:
                ep = planner_mod.plan_execution(
                    profiles, cm, policy=pol, chunk_bytes=cb, chunk_decode=cd, window=win,
                    batch_columns=self.batch_columns, fused_columns=fused_columns)
                self._plan_memo = _PlanMemo(key, profs, cm, _own_copy(ep), (times, scale),
                                            cm.n_observed)
                self.plans_built += 1
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
            window: int | None = None, names: Sequence[str] | None = None,
            preempt=None, on_ready=None,
            async_dispatch: bool | None = None) -> dict[str, ColumnExec]:
        """Transfer + decode the registered columns (all, those of ``names``
        -- the reference's ``run(encs)`` --, or those of ``order``, in that
        order) as ``plan`` decides; without a plan, one is built over them from
        the constructor's knobs.  ``window`` overrides the plan's (decode units
        in flight).  A ``fused`` decision decodes like any other (the flag is
        advisory; ``run_query`` fuses).  Measured actuals feed the cost model
        either way.  Returns per-column records once everything has finished.

        ``preempt`` (``() -> None``) is called before every decode unit but the
        first: the unit boundaries, and chunk (or span) k >= 1 of a per-chunk
        column, where the reference calls it; a nested ``run`` on this
        executor may run there.  ``on_ready(name)`` is called once per column,
        batched members included, once its last decode is complete on the
        device.  ``async_dispatch`` (None: the constructor's knob) issues the
        copies from a ``DispatchEngine`` transfer thread; the results are
        bitwise those of the inline path."""
        with span("run"):
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
            with span("run.prepare"):
                cols = {name: self._column(name, plan.decisions[name]) for name in order}
                units = self._units(order, plan.decisions, cols)
                leg = self._leg(units, window, cols)
            if not (self.async_dispatch if async_dispatch is None else async_dispatch):
                issuer = _InlineIssuer(leg.issue, len(units))
                res = _drive_seq(leg.decode(issuer, preempt, on_ready))
                wait_s = 0.0
            else:
                engine = DispatchEngine(host_window=self.cost_model.topology.host_window)
                try:
                    issuer = engine.issuer(leg.issue, len(units), held=leg.budget_flags())
                    res = engine.drive({0: (leg.decode(issuer, preempt, on_ready), issuer)})[0]
                finally:
                    engine.close()
                wait_s = engine.wait_s
            self.last_issue_s, self.last_wait_s = issuer.issue_s, wait_s
            for name, rec in res.items():
                self.cost_model.observe(name, rec.transfer_s, rec.decode_s)
            return res

    def _column(self, name: str, d: ColumnDecision) -> dict:
        """A column's state in one run: its decision, schedule and staging."""
        sched = self.chunk_schedule(name, d.chunk_bytes) if d.decode_mode == CHUNK else None
        staged = self._staging(name, d.chunk_bytes, sched)
        self._staged[name] = staged
        return {"decision": d, "sched": sched, "staged": staged}

    def _leg(self, units: list[_Unit], window: int, cols: dict,
             place: _Place | None = None) -> _Leg:
        device = self.device if place is None else place.device
        return (_CudaLeg if device.type == "cuda" else _HostLeg)(self, units, window, cols,
                                                                   place)

    def _place(self, device: torch.device, dev_id: int) -> _Place:
        """Logical device ``dev_id``'s place on ``device``: on a CUDA device a
        copy stream and a compute stream of its own, with every decode kernel
        loaded there (they load at construction on the executor's device)."""
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device.type != "cuda":
            return _Place(device)
        if self.backend in ("kernel", "baseline") and device != self.device:
            for lib in (FP_KERNEL, GP_KERNEL, NP_KERNEL):
                lib.load(device)
        streams = self._leg_streams.get((dev_id, device))
        if streams is None:
            streams = self._leg_streams[(dev_id, device)] = (torch.cuda.Stream(device),
                                                          torch.cuda.Stream(device))
        return _Place(device, *streams)

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
        src = col.get("column", name)       # a shard decodes its column's program
        prog = self._programs[src]
        if len(unit.members) > 1:
            out = prog.batched([cols[m]["staged"].views(flats[m]) for m in unit.members])
            for i, m in enumerate(unit.members):
                cols[m]["out"] = out[i]
            return
        if sched is None:
            col["out"] = prog(staged.views(flats[name]))
            return
        graph = self.graph(src)
        bufs = staged.views(flats[name], k)
        if k == 0:
            col["out"] = torch.empty(sum(sched.out_sizes) if "column" in col else graph.n_out,
                                     dtype=torch_dtype(graph.out_dtype),
                                     device=col.get("device", self.device))
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
        # a shard's output starts at its first span's: the kernels still see
        # the global offsets
        span({**bufs, **col["resident"]}, sched.out_starts[k], sched.g_starts[k],
             sched.out_sizes[k], col["out"], sched.out_starts[0] if "column" in col else 0)

    def _record(self, name: str, col: dict, transfer_s: float, decode_s: float,
                launches: int, batched_with: tuple[str, ...]) -> ColumnExec:
        src = col.get("column", name)
        enc = self._encoded[src]
        sched = col["sched"]
        return ColumnExec(
            name=name, array=col["out"], transfer_s=transfer_s, decode_s=decode_s,
            compressed_bytes=enc.compressed_nbytes, plain_bytes=enc.plain_nbytes,
            n_chunks=(sched.n_chunks if sched is not None
                      else self.n_transfer_chunks(name, col["decision"].chunk_bytes)),
            signature=self._programs[src].signature,
            batched_with=tuple(m for m in batched_with if m != name),
            decode_launches=col.get("units", 1 if sched is None else sched.n_chunks),
            chunk_decoded=sched is not None, kernel_launches=launches)

    # -------------------------------------------------------------------- mesh
    def physical_devices(self) -> list[torch.device]:
        """The physical devices a mesh's device ids map onto, by the
        reference's rule ``devices[id % len(devices)]``: every visible card
        for a CUDA executor, the host for a CPU one."""
        if self.device.type == "cuda":
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [self.device]

    def _shard_state(self, column: str, spec, d: ColumnDecision) -> dict:
        """One group-span shard's state in a leg: its range schedule and its
        staging (the whole-resident buffers, then each span's slices)."""
        sched = self.shard_schedule(column, d.chunk_bytes, spec.g_lo, spec.g_hi)
        if sched is None:
            raise ValueError(f"column {column!r} is not group-span shardable")
        key = (column, d.chunk_bytes, (spec.g_lo, spec.g_hi))
        if key not in self._stagings:
            self._stagings[key] = stage_chunks(plan_mod.host_operands(self._encoded[column]),
                                               sched, self.device.type == "cuda",
                                               self.register_split_s)
        return {"decision": d, "sched": sched, "staged": self._stagings[key], "column": column}

    def _mesh_leg(self, mesh_plan, dplan: ExecutionPlan, place: _Place) -> _Leg:
        """One logical device's leg: its whole columns in plan order (batched
        where the plan says), then each of its shards, span by span, over one
        transfer queue."""
        whole = [it for it in dplan.order if planner_mod.SHARD_SEP not in it]
        cols = {n: self._column(n, dplan.decisions[n]) for n in whole}
        units = self._units(whole, dplan.decisions, cols)
        for it in dplan.order:
            if planner_mod.SHARD_SEP in it:
                col = planner_mod.shard_column_of(it)
                spec = next(s for s in mesh_plan.shards[col] if s.name == it)
                cols[it] = self._shard_state(col, spec, dplan.decisions[it])
                units += [_Unit((it,), k) for k in range(cols[it]["sched"].n_chunks)]
        return self._leg(units, dplan.window, cols, place)

    @staticmethod
    def _d2d_target(mesh_plan, devices: list, dst_logical: int) -> tuple[int, torch.device]:
        """(device id, physical device) of a redistribution leg's destination."""
        ids = mesh_plan.device_ids
        dst_id = int(ids[dst_logical % len(ids)]) if ids else int(dst_logical)
        return dst_id, torch.device(devices[dst_id % len(devices)])

    def _d2d_copy(self, leg: "_D2DLeg"):
        """Copy a decoded shard into a fresh buffer on its destination: on a
        CUDA device on a stream of the destination's, after the shard's decode
        (``leg.after``), between two events, returning the last (a copy
        within one card's memory when both ends are the same card); on the
        CPU at once, timed by the host clock."""
        src, dev = leg.src, leg.device
        if dev.type != "cuda":
            t0 = time.perf_counter()
            leg.out = torch.empty_like(src, device=dev)
            leg.out.copy_(src)
            leg.t_end = time.perf_counter()
            leg.seconds = leg.t_end - t0
            return None
        stream = self._d2d_streams.get(dev)
        if stream is None:
            stream = self._d2d_streams[dev] = torch.cuda.Stream(dev)
        out = torch.empty_like(src, device=dev)
        # the fresh buffer may be one the caller's stream has just freed
        stream.wait_stream(torch.cuda.current_stream(dev))
        if leg.after is not None:
            stream.wait_event(leg.after)
        leg.c0, leg.c1 = _event(), _event()
        with torch.cuda.stream(stream):
            leg.c0.record(stream)
            out.copy_(src, non_blocking=True)
            leg.c1.record(stream)
        src.record_stream(stream)
        out.record_stream(stream)
        leg.out = out
        return leg.c1

    def _observe_link_actuals(self, dev_id: int, dplan: ExecutionPlan, recs) -> None:
        """Fold one leg's measured over predicted transfer time into the
        per-link EWMA (``CostModel.observe_link``)."""
        pred = sum(d.est_transfer_s for d in dplan.decisions.values())
        meas = sum(r.transfer_s for r in recs)
        if pred > 0.0 and meas > 0.0:
            self.cost_model.observe_link(dev_id, meas / pred)

    def _observe_d2d_actual(self, nbytes: int, copy_s: float) -> None:
        """Fold one fabric copy's time over the calibrated host-link time of
        the same bytes into the fabric EWMA (``CostModel.observe_d2d``)."""
        ref = self.cost_model.h2d_equiv_s(nbytes)
        if ref > 0.0 and copy_s > 0.0:
            self.cost_model.observe_d2d(copy_s / ref)

    def run_sharded(self, mesh_plan, encs: dict[str, plan_mod.Encoded] | None = None,
                    on_ready=None, concurrent: bool | None = None) -> MeshRunResult:
        """Execute a ``MeshExecutionPlan``: each logical device id runs one
        leg, on the physical device ``devices[id % len(devices)]`` of
        ``physical_devices()``, with a copy stream and a compute
        stream of its own: its whole columns as its ``ExecutionPlan`` decides,
        then its group-span shards, each decoded shard-local with the global
        group and output offsets into a shard-sized output.  A
        redistribution leg copies its shard to the final device as soon as
        it is decoded.  Sharded columns are assembled (``_assemble_shards``).

        ``concurrent`` (None: on when the legs with work sit on more than one
        physical device; on one card, sequential: there the legs share one
        link, one card and this thread, and the concurrent path measured
        slower) issues every leg's copies at once, one ``DispatchEngine`` transfer thread a leg
        under the plan topology's shared host-staging budget, the D2D legs on
        blocking issuers of their own, while this thread launches the legs'
        decodes as their items land; otherwise the legs run one after
        another, inline.  The results are bitwise the same either way.  Whole
        columns feed ``CostModel.observe``, every leg ``observe_link`` and
        every copy ``observe_d2d``; shards feed no per-column timing."""
        for name, enc in (encs or {}).items():
            if self._programs.get(name) is None or self._encoded.get(name) is not enc:
                self.compile(name, enc)
        devices = self.physical_devices()
        active = [int(mesh_plan.device_ids[li]) for li, p in enumerate(mesh_plan.plans)
                  if p.order]
        if concurrent is None:
            concurrent = len({devices[d % len(devices)] for d in active}) > 1
        redist = {it: int(dst) for it, _src, dst in mesh_plan.redistribution}
        per_device, device_launches, physical = {}, {}, {}
        legs: dict[int, tuple[int, ExecutionPlan, _Leg]] = {}
        d2d: dict[str, _D2DLeg] = {}
        for li, dplan in enumerate(mesh_plan.plans):
            dev_id = int(mesh_plan.device_ids[li])
            per_device[dev_id] = tuple(dplan.order)
            device_launches[dev_id] = 0
            physical[dev_id] = dev = devices[dev_id % len(devices)]
            if not dplan.order:
                continue
            legs[li] = (dev_id, dplan,
                        self._mesh_leg(mesh_plan, dplan, self._place(dev, dev_id)))
            for it in dplan.order:
                if it in redist and redist[it] != li:
                    d2d[it] = _D2DLeg(dev_id, *self._d2d_target(mesh_plan, devices, redist[it]))
        if concurrent and len(active) > 1:
            done = self._drive_concurrent(legs, d2d, mesh_plan.topology.host_window, on_ready)
        else:
            done = self._drive_sequential(legs, d2d, on_ready)
        results: dict[str, ColumnExec] = {}
        shard_recs: dict[str, list] = {}
        for li, (dev_id, dplan, _) in legs.items():
            seen: set[frozenset] = set()
            for it in dplan.order:
                rec = done[li][it]
                if planner_mod.SHARD_SEP not in it:
                    results[it] = rec
                    self.cost_model.observe(it, rec.transfer_s, rec.decode_s)
                    grp = frozenset((it,) + rec.batched_with)
                    if grp not in seen:          # batched members share one unit
                        seen.add(grp)
                        device_launches[dev_id] += rec.decode_launches
                    continue
                device_launches[dev_id] += rec.decode_launches
                col = planner_mod.shard_column_of(it)
                spec = next(s for s in mesh_plan.shards[col] if s.name == it)
                ent = d2d.get(it)
                if ent is None:
                    shard_recs.setdefault(col, []).append((spec, rec, dev_id, physical[dev_id]))
                    continue
                self._observe_d2d_actual(ent.out.numel() * ent.out.element_size(),
                                         ent.seconds)
                shard_recs.setdefault(col, []).append(
                    (spec, dataclasses.replace(rec, array=ent.out), ent.dst_id, ent.device))
            self._observe_link_actuals(dev_id, dplan, done[li].values())
        self._finish_sharded(results, shard_recs, on_ready)
        makespan = self._mesh_makespan([leg for _, _, leg in legs.values()], d2d.values())
        self.last_makespan_s = makespan
        return MeshRunResult(
            columns=results, per_device=per_device, device_launches=device_launches,
            plan=mesh_plan, d2d_copies={it: (e.src_id, e.dst_id, e.seconds)
                                        for it, e in d2d.items()},
            makespan_s=makespan,
            leg_makespan_s={dev_id: leg.makespan_s for dev_id, _, leg in legs.values()})

    def _drive_sequential(self, legs: dict, d2d: dict, on_ready) -> dict:
        """The legs one after another, each inline; a shard's D2D copy right
        after its leg, blocking."""
        done, issue_s = {}, 0.0
        for li, (_, dplan, leg) in legs.items():
            issuer = _InlineIssuer(leg.issue, len(leg.units))
            done[li] = _drive_seq(leg.decode(issuer, None, on_ready))
            issue_s += issuer.issue_s
            for it in dplan.order:
                ent = d2d.get(it)
                if ent is not None:
                    ent.src = done[li][it].array
                    t0 = time.perf_counter()
                    end = self._d2d_copy(ent)
                    if end is not None:
                        end.synchronize()
                        ent.seconds = ent.c0.elapsed_time(end) / 1e3
                    issue_s += time.perf_counter() - t0
        self.last_issue_s, self.last_wait_s = issue_s, 0.0
        return done

    def _drive_concurrent(self, legs: dict, d2d: dict, host_window: int | None,
                          on_ready) -> dict:
        """Every leg's transfer thread at once under one host-staging budget,
        the decode dispatcher round-robin over the legs on this thread, and
        each D2D copy on a blocking issuer of its own, filled the moment its
        shard's last span is launched."""
        engine = DispatchEngine(host_window=host_window)
        issuers = []
        try:
            for it, ent in d2d.items():
                ent.iss = engine.issuer(lambda i, e=ent: self._d2d_copy(e), 1,
                                        name=f"zipflow-d2d-{it}", sync=True)

            def on_shard(item: str, col: dict) -> None:
                ent = d2d.get(item)
                if ent is not None:
                    ent.src, ent.after = col["out"], col.get("d1")
                    ent.iss.advance(1)

            tasks = {}
            for li, (dev_id, _, leg) in legs.items():
                iss = engine.issuer(leg.issue, len(leg.units), held=leg.budget_flags(),
                                    name=f"zipflow-xfer-d{dev_id}")
                issuers.append(iss)
                tasks[li] = (leg.decode(iss, None, on_ready, on_shard, defer=True), iss)
            engine.drive(tasks)
            done = {li: leg.finish(on_ready) for li, (_, _, leg) in legs.items()}
            for ent in d2d.values():
                ent.iss.wait(1)
                if ent.c1 is not None:
                    ent.seconds = ent.c0.elapsed_time(ent.c1) / 1e3
        finally:
            engine.close()
        self.last_issue_s = sum(i.issue_s for i in issuers)
        self.last_wait_s = engine.wait_s
        return done

    def _mesh_makespan(self, legs: list[_Leg], d2d) -> float:
        """From the first leg's start to the last leg's or copy's end: by
        events on a CUDA device (per physical device, the longest), by the
        host clock on the CPU."""
        if not legs:
            return 0.0
        if not isinstance(legs[0], _CudaLeg):
            ends = [leg.t_end for leg in legs] + [e.t_end for e in d2d if e.t_end]
            return max(ends) - min(leg.t_run for leg in legs)
        spans: dict[torch.device, list] = {}
        for leg in legs:
            spans.setdefault(leg.device, [[], []])
            spans[leg.device][0].append(leg.start)
            spans[leg.device][1].append(leg.end)
        for e in d2d:
            if e.c1 is not None and e.device in spans:
                spans[e.device][1].append(e.c1)
        best = 0.0
        for starts, ends in spans.values():
            ref = starts[0]
            lo = min(ref.elapsed_time(ev) for ev in starts)
            hi = max(ref.elapsed_time(ev) for ev in ends)
            best = max(best, (hi - lo) / 1e3)
        return best

    def _finish_sharded(self, results: dict, shard_recs: dict, on_ready=None) -> None:
        """Assemble each sharded column from its shards (which already sit on
        their final devices) into one record; ``shard_devices`` are the final
        device ids, so the requested placement shows."""
        assembled = []
        for col in sorted(shard_recs):
            lst = sorted(shard_recs[col], key=lambda t: t[0].index)
            recs = [t[1] for t in lst]
            enc = self._encoded[col]
            results[col] = ColumnExec(
                name=col, array=self._assemble_shards([r.array for r in recs],
                                                      [t[3] for t in lst]),
                transfer_s=max(r.transfer_s for r in recs),
                decode_s=max(r.decode_s for r in recs),
                compressed_bytes=enc.compressed_nbytes, plain_bytes=enc.plain_nbytes,
                n_chunks=sum(r.n_chunks for r in recs),
                signature=self._programs[col].signature,
                decode_launches=sum(r.decode_launches for r in recs), chunk_decoded=True,
                kernel_launches=sum(r.kernel_launches for r in recs),
                shard_devices=tuple(t[2] for t in lst))
            assembled.append(col)
        if on_ready is None:
            return
        for dev in {results[c].array.device for c in assembled
                    if isinstance(results[c].array, torch.Tensor)}:
            if dev.type == "cuda":          # the joins are complete on the device
                torch.cuda.current_stream(dev).synchronize()
        for col in assembled:
            on_ready(col)

    @staticmethod
    def _assemble_shards(arrs: list, devs: list):
        """Join shard outputs, in index order, into one column: equal-size
        shards on distinct physical devices stay where they are, as a
        ``ShardedColumn``; uneven or co-located ones (on one card, always) are
        concatenated on the first shard's device."""
        if len(arrs) == 1:
            return arrs[0]
        devs = [torch.device(d) for d in devs]
        sizes = [int(a.shape[0]) for a in arrs]
        if len(set(sizes)) == 1 and len(set(devs)) == len(devs):
            return ShardedColumn(shards=tuple(a.to(d) for a, d in zip(arrs, devs)),
                                 devices=tuple(devs),
                                 starts=tuple(int(x) for x in np.cumsum([0] + sizes[:-1])))
        return torch.cat([a.to(devs[0]) for a in arrs])

    # ------------------------------------------------------------- serving
    def unregister(self, name: str) -> None:
        """Drop one registered blob's per-name state: its blob, program and
        graph entries, schedules, host stagings (their pinned memory goes back
        to the caching host allocator) and its cost-model profile and
        timings.  Compiled programs stay in the ProgramCache and the cost
        model's per-signature history survives, so a long-lived server keeps
        its calibration while per-request names come and go."""
        for store in (self._encoded, self._programs, self._graphs, self._staged):
            store.pop(name, None)
        for store in (self._schedules, self._stagings):
            for key in [k for k in store if k[0] == name]:
                store.pop(key)
        self.cost_model.forget(name)

    def run_one(self, enc: plan_mod.Encoded, name: str = "_single") -> torch.Tensor:
        """Decode one blob through the cache (a serving-path helper), then
        unregister it."""
        self.compile(name, enc)
        try:
            return self.run(names=[name])[name].array
        finally:
            self.unregister(name)

    # ------------------------------------------------------------- fused query
    @staticmethod
    def query_types(fq) -> dict[str, torch.dtype]:
        """The element type of every buffer a lowered query's Reduce reads, as
        its launches see them: the staged operands' device layout, the
        resident columns' decoded type, and that of any stage fusion left
        before the Reduce."""
        *pre, red = fq.graph.stages
        types = {k: torch.from_numpy(device_layout(np.empty(0, np.asarray(v).dtype))).dtype
                 for k, v in fq.operands.items()}
        for role in red.roles:
            for op in role.chain:
                for b in op.bufs:
                    types.setdefault(b, torch_dtype(role.dtype))    # a resident column
        for st in pre:
            types[st.out] = torch_dtype(st.out_dtype)
        return {b: types[b] for b in red.inputs}

    def prepare_query(self, fq) -> None:
        """Build and load the query kernel of a lowered query now (the kernel
        backend on a CUDA device; nothing elsewhere), so that no timed
        ``run_query`` compiles: its program is made from ``query_types``."""
        red = fq.graph.stages[-1]
        if self.backend not in ("kernel", "baseline") or self.device.type != "cuda" \
                or self._prepared.get(id(red)) is red:
            return
        query_reduce.program(red, {b: torch.empty(0, dtype=dt, device=self.device)
                                   for b, dt in self.query_types(fq).items()})
        self._prepared[id(red)] = red

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
        self.prepare_query(fq)          # a memo hit once the query's kernel is loaded
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
        # fused decode, not jit.  The query's kernel is built and loaded on the
        # card by ``prepare_query`` above, before the first event, so a cold
        # run's times stand as they are.
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
