"""plan_reused.load: share of traced loads, in %, whose program span
``repro_torch.plan`` holds a ``repro_torch.plan.reuse`` span: the loads whose
``StreamingExecutor.plan`` handed back its last search's plan instead of
searching again.  A program whose plans all search (one without a plan memo)
reads 0%; one without program spans reads None.

The profiled slice under-reads reuse: the profiler slows the host, which
stretches the per-column times the planner prices, so some profiled loads
search again where the same loads untraced would not.  The executor's
cumulative ``plans_built`` / ``plans_reused`` over the whole window would
read the untraced share."""
from zfbench.lib.spans import PROGRAM_PREFIX, program_spans


def read(run, name):
    if run.trace is None:
        return None
    plans = [evs for evs in program_spans(run.trace, "plan", "plan") if evs]
    if not plans:
        return None
    reuses = [e for e in run.trace.host if e.name == PROGRAM_PREFIX + "plan.reuse"]
    reused = sum(any(p.start <= r.start and r.end <= p.end for p in evs for r in reuses)
                 for evs in plans)
    return 100.0 * reused / len(plans)
