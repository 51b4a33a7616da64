"""The program's own spans in a traced slice.

The port marks its planner, executor and kernel-launch steps as ranges named
``repro_torch.<step>`` in the profiler's record, made only while a profiler
records (``repro_torch/core/trace.py``).  The
traced run's profiler records them beside the harness's spans
(``zfbench.<part>``), on the calling thread and on the clock of the device's
events, so ``Trace.host`` already holds them.  This module reads them: the
durations a metric reads, what the host was in by program step, and how far
the spans account for their parents.  A program without spans (an older
commit) gives nothing here, and a reader built on it then returns None.
"""
from __future__ import annotations

from zfbench.lib.trace import SPAN_PREFIX, HostEvent, Trace

PROGRAM_PREFIX = "repro_torch."


def _inside(ev: HostEvent, outer: HostEvent) -> bool:
    return outer.start <= ev.start and ev.end <= outer.end


def harness_spans(tr: Trace, part: str) -> list[HostEvent]:
    """The harness's spans ``zfbench.<part>`` of the slice, in order: one a
    traced call."""
    name = SPAN_PREFIX + part
    return sorted((e for e in tr.host if e.name == name), key=lambda e: e.start)


def program_spans(tr: Trace, part: str, name: str) -> list[list[HostEvent]]:
    """Per traced call in order (its harness span ``zfbench.<part>``), the
    program's spans ``repro_torch.<name>`` inside it."""
    full = PROGRAM_PREFIX + name
    evs = [e for e in tr.host if e.name == full]
    return [[e for e in evs if _inside(e, h)] for h in harness_spans(tr, part)]


def durations_ns(tr: Trace, part: str, name: str) -> list[list[int]]:
    """Per traced call in order, the durations (ns) of the program's spans
    ``repro_torch.<name>`` inside its harness span ``zfbench.<part>``."""
    return [[e.end - e.start for e in evs] for evs in program_spans(tr, part, name)]


def host_at(tr: Trace, times: list[int]) -> list[str]:
    """``Trace.host_at`` with the program's step: where a program span is open
    inside a harness span, ``<harness span>/<innermost repro_torch
    span>/<innermost other event inside it, or python>``; elsewhere exactly
    ``Trace.host_at``'s label."""
    base = tr.host_at(times)
    out = list(base)
    evs = sorted(tr.host, key=lambda e: (e.start, -e.end))
    stack: list[HostEvent] = []
    i = 0
    for q in sorted(range(len(times)), key=lambda k: times[k]):
        t = times[q]
        while i < len(evs) and evs[i].start <= t:
            while stack and stack[-1].end < evs[i].start:
                stack.pop()
            stack.append(evs[i])
            i += 1
        live = [e for e in stack if e.end >= t]
        prog = [e for e in live if e.name.startswith(PROGRAM_PREFIX)]
        if not prog or base[q] == "between calls":
            continue
        step = prog[-1]
        inner = [e.name for e in live if _inside(e, step)
                 and not e.name.startswith((PROGRAM_PREFIX, SPAN_PREFIX))]
        out[q] = f"{base[q].split('/', 1)[0]}/{step.name}/{inner[-1] if inner else 'python'}"
    return out


def breakdown(tr: Trace, top: int = 10) -> list[list]:
    """The device's idle time by what the host was in, with the program's
    steps (``host_at``): the ``top`` labels, seconds each."""
    gaps = tr.idle_gaps()
    by: dict[str, int] = {}
    for (a, b), n in zip(gaps, host_at(tr, [(a + b) // 2 for a, b in gaps])):
        by[n] = by.get(n, 0) + (b - a)
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _overlap(ivs: list[tuple[int, int]], a: int, b: int) -> int:
    return sum(max(0, min(y, b) - max(x, a)) for x, y in ivs)


def _union(ivs: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_coverage(tr: Trace, parent: str) -> float | None:
    """Of the device's idle time inside the program's spans
    ``repro_torch.<parent>``, the share that lies inside one of their child
    spans (``repro_torch.<parent>.<step>``).  None without such a span."""
    full = PROGRAM_PREFIX + parent
    parents = [e for e in tr.host if e.name == full]
    if not parents:
        return None
    children = _union([(e.start, e.end) for e in tr.host
                       if e.name.startswith(full + ".")
                       and any(_inside(e, p) for p in parents)])
    gaps = tr.idle_gaps()
    idle = covered = 0
    for p in parents:
        for a, b in gaps:
            lo, hi = max(a, p.start), min(b, p.end)
            if hi > lo:
                idle += hi - lo
                covered += _overlap(children, lo, hi)
    return covered / idle if idle else None


def containment(tr: Trace, part: str, name: str) -> list[float | None]:
    """Per traced call in order: the share of its harness span
    ``zfbench.<part>`` that its program spans ``repro_torch.<name>`` cover
    (None where it holds none)."""
    out = []
    for h, evs in zip(harness_spans(tr, part), program_spans(tr, part, name)):
        out.append(sum(e.end - e.start for e in evs) / (h.end - h.start)
                   if evs and h.end > h.start else None)
    return out
