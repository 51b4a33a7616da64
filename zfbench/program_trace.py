"""One traced run of a cell, read through the program's own spans.

    python3 zfbench/program_trace.py --workload <name> --seed <n> --seconds <s>
                                     [--rehearse --scale S]

Runs the cell as ``run.py --trace 1`` does and prints that run's result line;
then one more JSON line, ``{"program_trace": {...}}``, read from the same
traced slice with the spans the port records under ``torch.profiler``
(``repro_torch.<step>``, ``lib/spans.py``):

* ``idle_by_step``: the device's idle time by what the host was in, labelled
  ``<harness span>/<program step>/<innermost other event, or python>``;
* ``steps``: per program span name, its count, total and self time (less
  the program spans nested in it), in ms over the slice;
* ``idle_coverage``: the share of the device's idle time inside
  ``repro_torch.plan`` (``run``) that one of its child spans covers;
* ``in_harness``: per harness span ``plan`` (``run``), how many hold exactly
  one program span of the same name, the share of its duration that span
  covers (each call's, and the least), and the microseconds before and
  after it;
* ``plan_kinds``: per traced load, ``search`` where its ``repro_torch.plan``
  holds a ``plan.decide``, ``reuse`` where it holds a ``plan.reuse`` (the
  plan memo's hit), null where it holds neither;
* ``traced_load_ms``, ``untraced_load_ms``: mean wall time of a profiled load
  and of the window's other loads;
* ``h2d_copies_per_load``: host-to-device copies on the device per profiled
  load;
* ``device_ops_named_program``: device operations whose name starts with
  ``repro_torch.`` (a span taken for device work would show here).

A program without spans gives empty or null fields.  The benchmark's own runs
never run this.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def steps(tr) -> dict:
    """Per program span name: [count, total ms, self ms] over the slice."""
    from zfbench.lib.spans import PROGRAM_PREFIX

    evs = sorted((e for e in tr.host if e.name.startswith(PROGRAM_PREFIX)),
                 key=lambda e: (e.start, -e.end))
    child_ns = [0] * len(evs)
    stack: list[int] = []
    for i, e in enumerate(evs):
        while stack and evs[stack[-1]].end < e.end:
            stack.pop()
        if stack:
            child_ns[stack[-1]] += e.end - e.start
        stack.append(i)
    out: dict[str, list] = {}
    for e, c in zip(evs, child_ns):
        row = out.setdefault(e.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (e.end - e.start) / 1e6
        row[2] += (e.end - e.start - c) / 1e6
    return out


def summary(recs: list[dict], tr) -> dict:
    from zfbench.lib import spans
    from zfbench.lib.trace import H2D

    loads = [r for r in recs if r["op"] == "load"]
    traced = [r for r in loads if r.get("traced")]
    rest = [r for r in loads if not r.get("traced")]
    mean_ms = lambda rs: float(np.mean([r["t1"] - r["t0"] for r in rs])) * 1e3 if rs else None
    in_harness = {}
    for part in ("plan", "run"):
        held = spans.program_spans(tr, part, part)
        shares = [s for s in spans.containment(tr, part, part) if s is not None]
        outside = [[(evs[0].start - h.start) / 1e3, (h.end - evs[-1].end) / 1e3]
                   for h, evs in zip(spans.harness_spans(tr, part), held) if evs]
        in_harness[part] = {"harness_spans": len(held),
                            "holding_one": sum(len(h) == 1 for h in held),
                            "least_share": min(shares) if shares else None,
                            "shares": [round(x, 4) for x in shares],
                            "outside_us": [[round(a, 1), round(b, 1)] for a, b in outside]}
    kinds = ["search" if d else "reuse" if r else None
             for d, r in zip(spans.program_spans(tr, "plan", "plan.decide"),
                             spans.program_spans(tr, "plan", "plan.reuse"))]
    return {"program_trace": {
        "traced_loads": len(traced),
        "plan_kinds": kinds,
        "traced_load_ms": mean_ms(traced),
        "untraced_load_ms": mean_ms(rest),
        "h2d_copies_per_load": len(tr.ops(H2D)) / len(traced) if traced else None,
        "device_ops_named_program": sum(d.name.startswith(spans.PROGRAM_PREFIX)
                                        for d in tr.device),
        "in_harness": in_harness,
        "idle_coverage": {p: spans.idle_coverage(tr, p) for p in ("plan", "run")},
        "idle_by_step": spans.breakdown(tr, top=20),
        "steps": steps(tr)}}


def main(argv=None) -> int:
    from zfbench import run as runner
    from zfbench.lib import harness

    argv = list(sys.argv[1:] if argv is None else argv)
    caught = {}
    window = harness.window

    def traced_window(*a, **kw):
        recs, kept, tr = window(*a, **kw)
        caught.update(recs=recs, trace=tr)
        return recs, kept, tr

    harness.window = traced_window
    try:
        rc = runner.main(argv + ["--trace", "1"])
    finally:
        harness.window = window
    if rc:
        return rc
    if caught.get("trace") is None:
        print("program_trace: the window traced nothing", file=sys.stderr)
        return 5
    print(json.dumps(summary(caught["recs"], caught["trace"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
