"""The reader of ``plan_reused.load`` on synthetic traces: the share of traced
loads whose ``repro_torch.plan`` holds a ``repro_torch.plan.reuse``."""
import pytest

from zfbench.lib import registry, spans
from zfbench.lib.harness import Run
from zfbench.lib.trace import H2D, DeviceOp, HostEvent, Trace

NAME = "plan_reused.load"


def trace(reused=(False, True, True), stray=False, program=True):
    """Three loads as the harness spans them; with ``program`` the program's
    plan span inside each, holding a search or (``reused``) a reuse; with
    ``stray`` a reuse span inside a run, outside any plan."""
    host, dev = [], []
    p = lambda name, a, b: HostEvent(spans.PROGRAM_PREFIX + name, a, b)
    for i, hit in enumerate(reused):
        t = 1000 * i
        host += [HostEvent("zfbench.plan", t, t + 100), HostEvent("zfbench.run", t + 110, t + 500)]
        dev.append(DeviceOp("Memcpy HtoD (Pinned -> Device)", H2D, t + 120, t + 300, 4000))
        if program:
            host += [p("plan", t + 2, t + 98), p("run", t + 112, t + 498)]
            host.append(p("plan.reuse", t + 10, t + 20) if hit else p("plan.decide", t + 5, t + 90))
            if stray:
                host.append(p("plan.reuse", t + 200, t + 210))
    return Trace(device=dev, host=host, t0=0, t1=1000 * len(reused))


def run_of(tr):
    calls = [{"op": "load", "t0": i, "t1": i + 1, "plain_bytes": 10, "decode_units": 2,
              "traced": True} for i in range(3)]
    return Run(workload="w", config={}, traffic={}, device_kind="cpu", setup_s=1.0,
               window_s=2.0, calls=calls, trace=tr, counted={})


def read(run):
    return registry.metric_reader(NAME)(run, NAME)


@pytest.mark.parametrize("reused,want", [((False, True, True), 200 / 3),
                                         ((False, False, False), 0.0),
                                         ((True, True, True), 100.0)])
def test_the_share_of_loads_whose_plan_holds_a_reuse(reused, want):
    assert read(run_of(trace(reused))) == pytest.approx(want)


def test_a_reuse_span_outside_a_plan_span_counts_for_nothing():
    assert read(run_of(trace((False, False, True), stray=True))) == pytest.approx(100 / 3)


def test_nothing_to_read_without_a_trace_or_program_spans():
    assert read(run_of(None)) is None
    assert read(run_of(trace(program=False))) is None


def test_a_program_whose_plans_all_search_reads_zero():
    """A program without the plan memo records plan spans and no reuse: 0%."""
    tr = trace((False, False, False))
    assert not any(e.name.endswith("plan.reuse") for e in tr.host)
    assert read(run_of(tr)) == 0.0


def test_the_metric_is_a_planner_metric_of_both_load_cells():
    bench = registry.benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"], entry["moves"]) \
        == ("%", "higher", "program_span", "planner", "load_GBps")
    assert entry["workloads"] == ["tpch-sf4-table2.load", "tpch-sf8-lineitem-q1q6.load"]
    assert registry.metric_path(NAME).name == "plan_reused.py"
    for cell in entry["workloads"]:
        assert entry in registry.cell_metrics(bench, cell, per_layer=True)
