"""Streaming decode executor: whole-column FIFO streaming on one device.

This is the reference's ``StreamingExecutor`` in its ``policy="fifo",
chunk_bytes=None, chunk_decode=False`` configuration: each column's compressed
operands move host->device in one piece, in the given order, and decode in one
pass through the column's cached Program.  On a CUDA device:

  * ``compile`` packs a column's operands (leaf buffers + lifted meta) into one
    page-locked host buffer, so its transfer is a single copy;
  * ``run`` issues non-blocking H2D copies on the executor's copy stream, at most
    ``window`` columns ahead of decode (the copy of column k+window waits until
    the decode of column k has finished on the device);
  * the decode of column k waits on its copy event on the compute stream, so the
    transfer of column k+1 overlaps the decode of column k;
  * ``record_stream`` keeps the caching allocator from reusing a staged buffer
    before the compute stream is done with it.  The copy stream lives as long as
    the executor, so later runs reuse the staging blocks of earlier ones;
  * ``transfer_s`` / ``decode_s`` come from CUDA events, and so does the run's
    makespan (``last_makespan_s``).

The host enqueues everything without waiting on the device and synchronizes once
at the end.  On a CPU device the same code runs without streams, timed with the
host clock.  The planner, chunked and group-span streaming, batched launches and
the dispatch engine come in later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.compiler import Program, ProgramCache, compile_blob, device_layout
from repro_torch.kernels.fully_parallel import KERNEL as FP_KERNEL
from repro_torch.kernels.group_parallel import KERNEL as GP_KERNEL
from repro_torch.kernels.ref import torch_dtype

_ALIGN = 256     # byte alignment of each operand inside a staged column


@dataclasses.dataclass
class ColumnExec:
    """Execution record for one decoded column."""

    name: str
    array: torch.Tensor
    transfer_s: float
    decode_s: float
    compressed_bytes: int
    plain_bytes: int
    n_chunks: int
    signature: str
    kernel_launches: int = 0     # CUDA kernel launches of this column's decode


@dataclasses.dataclass(frozen=True)
class StagedColumn:
    """A column's operands packed into one host byte buffer (page-locked for a
    CUDA device); ``layout`` holds (name, byte offset, bytes, dtype, shape)."""

    host: torch.Tensor
    layout: tuple[tuple[str, int, int, torch.dtype, tuple[int, ...]], ...]

    def views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Every operand as a view into ``flat`` (a copy of ``host``)."""
        return {name: flat[off:off + nb].view(dt).view(shape)
                for name, off, nb, dt, shape in self.layout}


def stage_column(enc: plan_mod.Encoded, pin: bool = False) -> StagedColumn:
    arrays = {k: device_layout(v) for k, v in plan_mod.host_operands(enc).items()}
    layout, off = [], 0
    for k, a in arrays.items():
        layout.append((k, off, a.nbytes, torch_dtype(a.dtype), a.shape))
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    host = torch.empty(max(off, 1), dtype=torch.uint8, pin_memory=pin)
    for (_, o, nb, _, _), a in zip(layout, arrays.values()):
        host[o:o + nb].copy_(torch.from_numpy(a.reshape(-1).view(np.uint8)))
    return StagedColumn(host=host, layout=tuple(layout))


def _launches() -> int:
    return FP_KERNEL.launches + GP_KERNEL.launches


class StreamingExecutor:
    """Whole-column FIFO streaming decode over cached programs."""

    def __init__(self, backend: str, device: torch.device | str):
        self.backend = backend
        self.device = torch.device(device)
        self.cache = ProgramCache()
        self._encoded: dict[str, plan_mod.Encoded] = {}
        self._programs: dict[str, Program] = {}
        self._staged: dict[str, StagedColumn] = {}
        self._copy_stream: torch.cuda.Stream | None = None
        self.last_makespan_s: float | None = None

    # ------------------------------------------------------------------ compile
    def compile(self, name: str, enc: plan_mod.Encoded) -> Program:
        """Register a blob: its (cache-shared) Program and its host staging."""
        prog = compile_blob(enc, backend=self.backend, cache=self.cache)
        self._encoded[name] = enc
        self._programs[name] = prog
        self._staged[name] = stage_column(enc, pin=self.device.type == "cuda")
        return prog

    def graph(self, name: str):
        return self._programs[name].graph

    # --------------------------------------------------------------------- run
    def run(self, order: Sequence[str] | None = None,
            window: int = 2) -> dict[str, ColumnExec]:
        """Transfer + decode the registered columns (all, or ``order``) in order,
        with at most ``window`` columns in flight; returns per-column records
        once everything has finished."""
        order = list(self._encoded) if order is None else list(order)
        unknown = [n for n in order if n not in self._encoded]
        if unknown:
            raise KeyError(f"columns not registered: {unknown}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if self.device.type == "cuda":
            return self._run_cuda(order, window)
        return self._run_host(order)

    def _record(self, name: str, out: torch.Tensor, transfer_s: float,
                decode_s: float, launches: int) -> ColumnExec:
        enc = self._encoded[name]
        return ColumnExec(
            name=name, array=out, transfer_s=transfer_s, decode_s=decode_s,
            compressed_bytes=enc.compressed_nbytes, plain_bytes=enc.plain_nbytes,
            n_chunks=1, signature=self._programs[name].signature,
            kernel_launches=launches)

    def _run_host(self, order: list[str]) -> dict[str, ColumnExec]:
        results = {}
        t_run = time.perf_counter()
        for name in order:
            staged = self._staged[name]
            t0 = time.perf_counter()
            bufs = staged.views(staged.host.to(self.device))
            t1 = time.perf_counter()
            before = _launches()
            out = self._programs[name](bufs)
            results[name] = self._record(name, out, t1 - t0,
                                         time.perf_counter() - t1,
                                         _launches() - before)
        self.last_makespan_s = time.perf_counter() - t_run
        return results

    def _run_cuda(self, order: list[str], window: int) -> dict[str, ColumnExec]:
        dev = self.device
        compute = torch.cuda.current_stream(dev)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        copy = self._copy_stream

        def event() -> torch.cuda.Event:
            return torch.cuda.Event(enable_timing=True)

        start, end = event(), event()
        start.record(compute)
        copy.wait_event(start)          # no copy starts before the run does
        copy_ev: list[tuple] = []
        flats: list[torch.Tensor | None] = []
        decoded: list[torch.cuda.Event] = []

        def issue(k: int) -> None:
            if k >= window:             # at most `window` columns ahead of decode
                copy.wait_event(decoded[k - window])
            c0, c1 = event(), event()
            with torch.cuda.stream(copy):
                c0.record(copy)
                flats.append(self._staged[order[k]].host.to(dev, non_blocking=True))
                c1.record(copy)
            copy_ev.append((c0, c1))

        for k in range(min(window, len(order))):
            issue(k)
        outs, dec_ev, launches = [], [], []
        for k, name in enumerate(order):
            compute.wait_event(copy_ev[k][1])
            flats[k].record_stream(compute)
            bufs = self._staged[name].views(flats[k])
            flats[k] = None             # the allocator owns the buffer from here
            d0, d1 = event(), event()
            d0.record(compute)
            before = _launches()
            outs.append(self._programs[name](bufs))
            launches.append(_launches() - before)
            d1.record(compute)
            dec_ev.append((d0, d1))
            decoded.append(d1)
            del bufs
            if k + window < len(order):
                issue(k + window)
        end.record(compute)
        end.synchronize()
        self.last_makespan_s = start.elapsed_time(end) / 1e3
        return {name: self._record(
                    name, outs[k], copy_ev[k][0].elapsed_time(copy_ev[k][1]) / 1e3,
                    dec_ev[k][0].elapsed_time(dec_ev[k][1]) / 1e3, launches[k])
                for k, name in enumerate(order)}
