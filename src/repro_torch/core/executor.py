"""Streaming decode executor on one device: whole-column, chunked-transfer and
per-chunk (element or group-span) streaming.

This is the reference's ``StreamingExecutor`` in its ``policy="fifo"``
configuration, without batched launches (a planner decision, ported with the
planner).  ``chunk_bytes`` and ``chunk_decode`` take the reference's meaning:

  * ``chunk_bytes=None`` -- each column moves host->device in one copy and
    decodes in one pass through its cached Program (whole-column FIFO);
  * ``chunk_bytes`` set, ``chunk_decode=False`` -- every leaf buffer moves in
    row-granular pieces of at most ``chunk_bytes`` (``split_chunks``), and the
    column still decodes whole once its last piece has landed;
  * ``chunk_decode=True`` as well -- a column whose graph splits
    (``chunk_schedule``: element chunks of a Fully-Parallel graph, or spans of
    whole groups behind a Group-Parallel or Non-Parallel stage) decodes each
    chunk in its own launch while later chunks are still in flight: the
    paper's chunk-level overlap.  Every chunk writes its range of the column's
    output in place.  A group-span column first runs its prologue (the presum)
    once, after its whole-resident buffers land.

On a CUDA device:

  * ``compile`` packs a column's operands into one page-locked host buffer: the
    buffers every decode unit reads first, then, for a per-chunk column, the
    slices of chunk 0, chunk 1, ... each 256-byte aligned, so the transfer of
    one chunk is one copy of a contiguous range;
  * ``run`` issues those copies on the executor's copy stream into one device
    buffer per column, at most ``window`` decode units ahead of decode (the
    copies of unit u+window wait until the decode of unit u has finished on
    the device); a decode unit is a whole column or one chunk;
  * the decode of a unit waits on the event recorded after its last copy on
    the compute stream, so transfers overlap decode;
  * ``record_stream`` keeps the caching allocator from reusing a device buffer
    before the compute stream is done with it;
  * ``transfer_s`` runs from a column's first copy to its last, ``decode_s``
    from its first launch to its last, and ``last_makespan_s`` over the run,
    all by CUDA events.

The host enqueues everything without waiting on the device and synchronizes once
at the end.  On a CPU device the same units run in order, timed with the host
clock.  The planner, batched launches and the dispatch engine come later.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core import plan as plan_mod
from repro_torch.core.compiler import Program, ProgramCache, build_graph, device_layout
from repro_torch.core.ir import DecodeGraph, element_chunk_layout, group_chunk_layout
from repro_torch.kernels.fully_parallel import KERNEL as FP_KERNEL
from repro_torch.kernels.group_parallel import KERNEL as GP_KERNEL
from repro_torch.kernels.non_parallel import KERNEL as NP_KERNEL
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
    decode_launches: int = 1     # decode units: chunks (+ a prologue), or 1
    chunk_decoded: bool = False
    kernel_launches: int = 0     # CUDA kernel launches of this column's decode


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


def stage_column(enc: plan_mod.Encoded, pin: bool = False,
                 sched: ChunkSchedule | None = None,
                 chunk_bytes: int | None = None) -> StagedColumn:
    """Pack a column for transfer: whole (one copy, or one copy per
    ``split_chunks`` piece of each leaf with the meta operands in one), or per
    chunk of ``sched`` (the whole buffers in one copy, then one per chunk)."""
    ops = plan_mod.host_operands(enc)
    leaves = plan_mod.flat_buffers(enc)
    arrays: list[tuple[str, np.ndarray]] = []
    copies: list[tuple[int, int]] = []
    pieces: list[tuple[Entry, ...]] = []

    def add(a: int, b: int) -> None:
        if b > a:
            copies.append((a, b))

    if sched is None:
        names = [k for k in ops if k not in leaves] + list(leaves)   # meta first
        arrays = [(k, device_layout(ops[k])) for k in names]
        layout, end = _place(arrays, 0)
        if chunk_bytes is None:
            add(0, end)
        else:
            n_meta = len(ops) - len(leaves)
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
        needs = (len(copies),)
    else:
        arrays = [(k, device_layout(sched.host_push[k] if k in sched.host_push
                                    else ops[k])) for k in sched.whole]
        layout, end = _place(arrays, 0)
        add(0, end)
        needs = []
        for i in range(sched.n_chunks):
            chunk = [(k, device_layout(sched.piece(np.asarray(ops[k]), k, i)))
                     for k in sched.slices]
            entries, stop = _place(chunk, end)
            pieces.append(tuple(entries))
            arrays += chunk
            add(end, stop)
            needs.append(len(copies))
            end = stop
        needs = tuple(needs)
    host = torch.empty(max(end, 1), dtype=torch.uint8, pin_memory=pin)
    for (_, o, nb, _, _), (_, a) in zip(layout + [e for p in pieces for e in p], arrays):
        host[o:o + nb].copy_(torch.from_numpy(a.reshape(-1).view(np.uint8)))
    return StagedColumn(host=host, layout=tuple(layout), copies=tuple(copies),
                        needs=needs, pieces=tuple(pieces))


def _launches() -> int:
    return FP_KERNEL.launches + GP_KERNEL.launches + NP_KERNEL.launches


class StreamingExecutor:
    """FIFO streaming decode over cached programs: whole-column, chunked
    transfer, or per-chunk decode (``chunk_bytes``, ``chunk_decode``)."""

    _DEFAULTS = object()     # "use the constructor's chunk configuration"

    def __init__(self, backend: str, device: torch.device | str,
                 chunk_bytes: int | None = None, chunk_decode: bool = False):
        self.backend = backend
        self.device = torch.device(device)
        self.chunk_bytes = chunk_bytes
        self.chunk_decode = chunk_decode
        self.cache = ProgramCache()
        self._encoded: dict[str, plan_mod.Encoded] = {}
        self._programs: dict[str, Program] = {}
        self._graphs: dict[str, DecodeGraph] = {}
        self._staged: dict[str, StagedColumn] = {}
        self._schedules: dict[tuple[str, int], ChunkSchedule | None] = {}
        self._copy_stream: torch.cuda.Stream | None = None
        self.last_makespan_s: float | None = None

    # ------------------------------------------------------------------ compile
    def compile(self, name: str, enc: plan_mod.Encoded) -> Program:
        """Register a blob: its (cache-shared) Program and its host staging."""
        graph = build_graph(enc)
        prog = self.cache.get(graph, backend=self.backend)
        self._encoded[name] = enc
        self._programs[name] = prog
        # the column's own graph: its group offsets and rANS word counts are
        # data, while the shared program's graph is the first column's
        self._graphs[name] = graph
        for key in [k for k in self._schedules if k[0] == name]:
            self._schedules.pop(key)
        self._staged[name] = stage_column(enc, pin=self.device.type == "cuda",
                                          sched=self.chunk_schedule(name),
                                          chunk_bytes=self.chunk_bytes)
        return prog

    def graph(self, name: str) -> DecodeGraph:
        return self._graphs[name]

    @property
    def copy_stream(self) -> torch.cuda.Stream:
        """The CUDA stream every host->device copy of this executor runs on."""
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._copy_stream

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
            chunk_bytes = self.chunk_bytes
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
        ops = plan_mod.host_operands(self._encoded[name])
        ratios: dict[str, tuple[int, int]] = {}
        per_elem = 0.0
        for nm, spec in layout.tiled.items():
            num = int(ops[spec.num_op][0]) if spec.num_op else int(spec.num)
            ratios[nm] = (num, int(spec.den))
            per_elem += num / spec.den * np.dtype(ops[nm].dtype).itemsize
        n = int(graph.n_out)
        # ~chunk_bytes of compressed tile bytes per chunk, on the alignment
        chunk_elems = costmodel.aligned_chunk_elems(chunk_bytes, per_elem,
                                                    int(layout.align))
        if chunk_elems >= n:
            return None
        out_starts = tuple(range(0, n, chunk_elems))
        out_sizes = tuple(min(chunk_elems, n - s) for s in out_starts)
        slices: dict[str, list[tuple[int, int]]] = {}
        for nm, (num, den) in ratios.items():
            length = int(ops[nm].shape[0])
            per = []
            for s, sz in zip(out_starts, out_sizes):
                lo = (s * num) // den
                # the last chunk takes the remaining rows (guard words too);
                # inner boundaries are aligned, so the slices are exact
                hi = length if s + sz >= n else ((s + sz) * num) // den
                per.append((lo, max(hi, lo + 1)))
            slices[nm] = per
        return ChunkSchedule(out_starts=out_starts, out_sizes=out_sizes,
                             slices=slices, whole=layout.whole)

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

    # --------------------------------------------------------------------- run
    def run(self, order: Sequence[str] | None = None,
            window: int = 2) -> dict[str, ColumnExec]:
        """Transfer + decode the registered columns (all, or ``order``) in order,
        with at most ``window`` decode units in flight; returns per-column
        records once everything has finished."""
        order = list(self._encoded) if order is None else list(order)
        unknown = [n for n in order if n not in self._encoded]
        if unknown:
            raise KeyError(f"columns not registered: {unknown}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        units = [(name, k) for name in order
                 for k in range(len(self._staged[name].needs))]
        if self.device.type == "cuda":
            return self._run_cuda(order, units, window)
        return self._run_host(order, units)

    def _decode(self, name: str, k: int, flat: torch.Tensor, col: dict) -> None:
        """Decode unit k of a column from its device buffer ``flat``; ``col``
        carries the column's output and prologue results between units."""
        staged = self._staged[name]
        sched = self.chunk_schedule(name)
        graph = self.graph(name)
        if sched is None:
            col["out"] = self._programs[name](staged.views(flat))
            return
        bufs = staged.views(flat, k)
        if k == 0:
            col["out"] = torch.empty(graph.n_out, dtype=torch_dtype(graph.out_dtype),
                                     device=self.device)
        if sched.kind == "element":
            prog = self.cache.get_chunk(graph, sched.out_sizes[k], self.backend)
            prog(bufs, sched.out_starts[k], col["out"])
            return
        if k == 0:
            pro = self.cache.get_group_prologue(graph, self.backend)
            col["resident"] = pro(bufs) if pro is not None else {}
            col["units"] = sched.n_chunks + (pro is not None)
        prog = self.cache.get_group_chunk(graph, sched.g_sizes[k], sched.pad_sizes[k],
                                          self.backend)
        prog({**bufs, **col["resident"]}, sched.out_starts[k], sched.g_starts[k],
             sched.out_sizes[k], col["out"])

    def _record(self, name: str, col: dict, transfer_s: float, decode_s: float,
                launches: int) -> ColumnExec:
        enc = self._encoded[name]
        sched = self.chunk_schedule(name)
        return ColumnExec(
            name=name, array=col["out"], transfer_s=transfer_s, decode_s=decode_s,
            compressed_bytes=enc.compressed_nbytes, plain_bytes=enc.plain_nbytes,
            n_chunks=(sched.n_chunks if sched is not None
                      else self.n_transfer_chunks(name, self.chunk_bytes)),
            signature=self._programs[name].signature,
            decode_launches=col.get("units", 1 if sched is None else sched.n_chunks),
            chunk_decoded=sched is not None, kernel_launches=launches)

    def _run_host(self, order: list[str], units) -> dict[str, ColumnExec]:
        cols = {name: {"transfer": 0.0, "decode": 0.0, "launches": 0} for name in order}
        flats: dict[str, torch.Tensor] = {}
        t_run = time.perf_counter()
        for name, k in units:
            staged, col = self._staged[name], cols[name]
            t0 = time.perf_counter()
            if k == 0:
                flats[name] = torch.empty_like(staged.host, device=self.device)
            first = staged.needs[k - 1] if k else 0
            for a, b in staged.copies[first:staged.needs[k]]:
                flats[name][a:b].copy_(staged.host[a:b])
            t1 = time.perf_counter()
            before = _launches()
            self._decode(name, k, flats[name], col)
            col["launches"] += _launches() - before
            col["transfer"] += t1 - t0
            col["decode"] += time.perf_counter() - t1
        self.last_makespan_s = time.perf_counter() - t_run
        return {name: self._record(name, c, c["transfer"], c["decode"], c["launches"])
                for name, c in cols.items()}

    def _run_cuda(self, order: list[str], units, window: int) -> dict[str, ColumnExec]:
        dev = self.device
        compute = torch.cuda.current_stream(dev)
        copy = self.copy_stream

        def event() -> torch.cuda.Event:
            return torch.cuda.Event(enable_timing=True)

        start, end = event(), event()
        start.record(compute)
        copy.wait_event(start)          # no copy starts before the run does
        cols = {name: {} for name in order}
        flats: dict[str, torch.Tensor] = {}
        landed: list[torch.cuda.Event] = []    # per unit: after its last copy
        decoded: list[torch.cuda.Event] = []   # per unit: after its decode

        def issue(u: int) -> None:
            if u >= window:             # at most `window` units ahead of decode
                copy.wait_event(decoded[u - window])
            name, k = units[u]
            staged, col = self._staged[name], cols[name]
            with torch.cuda.stream(copy):
                if k == 0:
                    col["c0"] = event()
                    col["c0"].record(copy)
                    flats[name] = torch.empty(staged.host.numel(), dtype=torch.uint8,
                                              device=dev)
                first = staged.needs[k - 1] if k else 0
                for a, b in staged.copies[first:staged.needs[k]]:
                    flats[name][a:b].copy_(staged.host[a:b], non_blocking=True)
                ev = event()
                ev.record(copy)
            landed.append(ev)

        for u in range(min(window, len(units))):
            issue(u)
        for u, (name, k) in enumerate(units):
            col = cols[name]
            compute.wait_event(landed[u])
            if k == 0:
                flats[name].record_stream(compute)
                col["d0"] = event()
                col["d0"].record(compute)
                col["launches"] = _launches()
            self._decode(name, k, flats[name], col)
            d1 = event()
            d1.record(compute)
            decoded.append(d1)
            if k == len(self._staged[name].needs) - 1:
                col["c1"], col["d1"] = landed[u], d1
                col["launches"] = _launches() - col["launches"]
                del flats[name]         # the allocator owns the buffer from here
            if u + window < len(units):
                issue(u + window)
        end.record(compute)
        end.synchronize()
        self.last_makespan_s = start.elapsed_time(end) / 1e3
        return {name: self._record(name, c, c["c0"].elapsed_time(c["c1"]) / 1e3,
                                   c["d0"].elapsed_time(c["d1"]) / 1e3, c["launches"])
                for name, c in cols.items()}
