"""The traced slice of a ``--trace 1`` run, read from ``torch.profiler``.

``Trace`` holds the device's operations (kernels, copies, memsets) and the
host's events on the calling thread, in one clock (nanoseconds), over the
window from the first traced call's start to the last one's end.  The
harness's own spans (``zfbench.<part>``, from ``record_function``) name what
the host was in.  Busy time is the union of the device's intervals, never
their sum: copies and kernels overlap.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

SPAN_PREFIX = "zfbench."

H2D, D2H, D2D, MEMSET, KERNEL = "memcpy_h2d", "memcpy_d2h", "memcpy_d2d", "memset", "kernel"


def device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        if "HtoD" in name:
            return H2D
        if "DtoH" in name:
            return D2H
        return D2D
    if name.startswith("Memset"):
        return MEMSET
    return KERNEL


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str
    start: int
    end: int
    nbytes: int


@dataclasses.dataclass
class HostEvent:
    name: str
    start: int
    end: int


@dataclasses.dataclass
class Trace:
    device: list[DeviceOp]
    host: list[HostEvent]            # the calling thread's, spans included
    t0: int
    t1: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def ops(self, *kinds: str) -> list[DeviceOp]:
        return [d for d in self.device if not kinds or d.kind in kinds]

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of every device operation's interval, clipped to the window."""
        ivs = sorted((max(d.start, self.t0), min(d.end, self.t1)) for d in self.device
                     if d.end > self.t0 and d.start < self.t1)
        out: list[list[int]] = []
        for a, b in ivs:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> list[tuple[int, int]]:
        gaps, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        return gaps

    def host_at(self, times: list[int]) -> list[str]:
        """What the host was in at each time: ``<span>/<innermost event>``,
        ``<span>/python`` where no profiled operation ran (the program's own
        Python), ``between calls`` outside the harness's spans."""
        evs = sorted(self.host, key=lambda e: (e.start, -e.end))
        order = sorted(range(len(times)), key=lambda i: times[i])
        out = [""] * len(times)
        stack: list[HostEvent] = []
        i = 0
        for q in order:
            t = times[q]
            while i < len(evs) and evs[i].start <= t:
                while stack and stack[-1].end < evs[i].start:
                    stack.pop()
                stack.append(evs[i])
                i += 1
            live = [e for e in stack if e.end >= t]
            spans = [e.name[len(SPAN_PREFIX):] for e in live if e.name.startswith(SPAN_PREFIX)]
            inner = [e.name for e in live if not e.name.startswith(SPAN_PREFIX)]
            if not spans:
                out[q] = "between calls"
            else:
                out[q] = f"{spans[-1]}/{inner[-1] if inner else 'python'}"
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_op: dict[str, int] = {}
        for d in self.device:
            key = d.name[:160]
            by_op[key] = by_op.get(key, 0) + (d.end - d.start)
        gaps = self.idle_gaps()
        names = self.host_at([(a + b) // 2 for a, b in gaps])
        by_gap: dict[str, int] = {}
        for (a, b), n in zip(gaps, names):
            by_gap[n] = by_gap.get(n, 0) + (b - a)
        rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v / 1e9] for k, v in rank(by_op)],
                "idle_gaps": [[k, v / 1e9] for k, v in rank(by_gap)]}


def _exported_h2d_bytes(prof, n: int) -> list[int]:
    """The bytes of each host-to-device copy, in start order, from the
    profiler's exported trace (its events in memory carry no sizes); all 0
    if the export does not give one for each copy."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    rows = sorted((float(e["ts"]), int(e.get("args", {}).get("bytes", 0)))
                  for e in data.get("traceEvents", [])
                  if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""))
    if len(rows) != n:
        return [0] * n
    return [b for _, b in rows]


def from_profiler(prof) -> Trace:
    """The ``Trace`` of a stopped ``torch.profiler.profile``."""
    import torch

    events = prof.profiler.kineto_results.events()
    device, host, spans = [], [], []
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            name = ev.name()
            if name.startswith(SPAN_PREFIX) or ev.is_user_annotation():
                continue                 # a span's range on the device's timeline, not work
            device.append(DeviceOp(name, device_kind(name), ev.start_ns(), ev.end_ns(), 0))
        else:
            host.append((ev, HostEvent(ev.name(), ev.start_ns(), ev.end_ns())))
            if ev.name().startswith(SPAN_PREFIX):
                spans.append(ev)
    if not spans:
        raise RuntimeError("the profiler recorded none of the harness's spans")
    copies = sorted((d for d in device if d.kind == H2D), key=lambda d: d.start)
    for d, n in zip(copies, _exported_h2d_bytes(prof, len(copies))):
        d.nbytes = n
    thread = spans[0].start_thread_id()
    host = [h for ev, h in host if ev.start_thread_id() == thread]
    t0 = min(s.start_ns() for s in spans)
    t1 = max(s.end_ns() for s in spans)
    return Trace(device=device, host=host, t0=t0, t1=t1)
