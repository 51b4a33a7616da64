"""The program's spans in a traced slice (``lib/spans.py``), the readers built
on them, and a rehearsed traced run that prints them."""
import contextlib
import gc
import io
import json
import os
import sys
import types
from unittest import mock

import pytest
import torch

from zfbench.lib import registry, spans
from zfbench.lib.harness import Run
from zfbench.lib.trace import H2D, KERNEL, DeviceOp, HostEvent, Trace, from_profiler

READERS = ("plan_ms.load", "host_us_per_unit.load", "stagings_built.load")


def harness_trace():
    """Two loads as the harness spans them, with no program span (as an older
    program gives)."""
    dev = [DeviceOp("Memcpy HtoD (Pinned -> Device)", H2D, 130, 170, 4000),
           DeviceOp("zf_kernel", KERNEL, 160, 190, 0),
           DeviceOp("zf_kernel", KERNEL, 430, 480, 0)]
    host = [HostEvent("zfbench.plan", 0, 100), HostEvent("aten::empty", 20, 30),
            HostEvent("zfbench.run", 110, 200), HostEvent("aten::copy_", 123, 127),
            HostEvent("zfbench.plan", 300, 400), HostEvent("zfbench.run", 410, 500)]
    return Trace(device=dev, host=host, t0=0, t1=500)


def program_trace():
    """The same two loads with the program's spans inside the harness's."""
    tr = harness_trace()
    p = lambda name, a, b: HostEvent(spans.PROGRAM_PREFIX + name, a, b)
    tr.host += [p("plan", 2, 98), p("plan.decide", 5, 60), p("plan.order", 60, 90),
                p("run", 112, 198), p("run.prepare", 112, 122), p("run.stage", 114, 121),
                p("run.issue", 122, 130), p("run.unit", 150, 180), p("run.decode", 152, 178),
                p("run.sync", 180, 196),
                p("plan", 301, 399), p("plan.decide", 302, 380),
                p("run", 411, 499), p("run.prepare", 411, 415), p("run.unit", 420, 440),
                p("run.unit", 440, 460), p("run.sync", 460, 498)]
    return tr


def run_of(tr, units=(2, 4)):
    calls = [{"op": "load", "t0": i, "t1": i + 1, "plain_bytes": 10, "decode_units": u,
              "issue_s": 0.001, "makespan_s": 0.002, "traced": True}
             for i, u in enumerate(units)]
    return Run(workload="w", config={}, traffic={}, device_kind="cpu", setup_s=1.0,
               window_s=2.0, calls=calls, trace=tr, counted={})


def read(run, name):
    return registry.metric_reader(name)(run, name)


@pytest.mark.parametrize("make", [harness_trace, program_trace])
def test_labels_without_a_program_span_are_the_harness_labels(make):
    tr = make()
    times = [10, 25, 50, 105, 123, 127, 140, 250, 390, 505]
    mine, theirs = spans.host_at(tr, times), tr.host_at(times)
    for t, a, b in zip(times, mine, theirs):
        if not any(e.name.startswith(spans.PROGRAM_PREFIX) and e.start <= t <= e.end
                   for e in tr.host):
            assert a == b
    assert spans.host_at(harness_trace(), times) == harness_trace().host_at(times)


def test_labels_name_the_program_step():
    tr = program_trace()
    assert spans.host_at(tr, [10, 25, 50, 75, 99, 105, 118, 123, 140, 165, 190, 250]) == [
        "plan/repro_torch.plan.decide/python", "plan/repro_torch.plan.decide/aten::empty",
        "plan/repro_torch.plan.decide/python", "plan/repro_torch.plan.order/python",
        "plan/python", "between calls", "run/repro_torch.run.stage/python",
        "run/repro_torch.run.issue/aten::copy_", "run/repro_torch.run/python",
        "run/repro_torch.run.decode/python", "run/repro_torch.run.sync/python",
        "between calls"]
    # each idle gap goes to what the host was in at its middle
    assert dict(map(tuple, spans.breakdown(tr))) == pytest.approx({
        "plan/repro_torch.plan.order/python": 130e-9,
        "plan/repro_torch.plan.decide/python": 240e-9,
        "run/repro_torch.run.sync/python": 20e-9})


def test_coverage_and_containment():
    tr = program_trace()
    # plan: 96 + 98 ns of idle device, children 55 + 30 and 78
    assert spans.idle_coverage(tr, "plan") == pytest.approx((55 + 30 + 78) / (96 + 98))
    assert spans.containment(tr, "plan", "plan") == [pytest.approx(0.96),
                                                     pytest.approx(0.98)]
    assert [len(s) for s in spans.program_spans(tr, "run", "run.unit")] == [1, 2]
    assert spans.durations_ns(tr, "run", "run.sync") == [[16], [38]]
    assert spans.idle_coverage(harness_trace(), "run") is None
    assert spans.containment(harness_trace(), "run", "run") == [None, None]


def test_readers_on_the_program_spans():
    run = run_of(program_trace())
    assert read(run, "plan_ms.load") == pytest.approx((96 + 98) / 2 / 1e6)
    # run less its sync, per decode unit, in us
    assert read(run, "host_us_per_unit.load") == pytest.approx(
        ((86 - 16) / 2 + (88 - 38) / 4) / 2 / 1e3)
    assert read(run, "stagings_built.load") == 0.5


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_program_spans(name):
    assert read(run_of(harness_trace()), name) is None
    assert read(run_of(None), name) is None


def test_host_us_per_unit_needs_one_record_a_traced_load():
    assert read(run_of(program_trace(), units=(2,)), "host_us_per_unit.load") is None


def test_the_device_timeline_holds_no_program_span():
    """A span's range on the device's timeline (a user annotation there) is
    not device work: ``from_profiler`` leaves it out."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, a, b, annotation=False):
        return types.SimpleNamespace(
            name=lambda: name, device_type=lambda: dev, start_ns=lambda: a,
            end_ns=lambda: b, is_user_annotation=lambda: annotation,
            start_thread_id=lambda: 1)

    events = [ev("zfbench.run", cpu, 0, 100, True), ev("repro_torch.run", cpu, 1, 99, True),
              ev("repro_torch.run.decode", cpu, 10, 20, True),
              ev("repro_torch.run", cuda, 1, 99, True),
              ev("repro_torch.run.decode", cuda, 10, 40, True),
              ev("zf_kernel", cuda, 15, 35)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    with mock.patch("zfbench.lib.trace._exported_h2d_bytes", lambda prof, n: [0] * n):
        tr = from_profiler(prof)
    assert [d.name for d in tr.device] == ["zf_kernel"]
    assert [h.name for h in tr.host] == ["zfbench.run", "repro_torch.run",
                                         "repro_torch.run.decode"]


def rehearse_traced(workload: str) -> tuple[dict, dict]:
    """A rehearsed ``--trace 1`` run of ``workload`` through
    ``program_trace.py``, traced from its second call: its result line and
    its ``program_trace`` line."""
    from zfbench import program_trace
    from zfbench.lib import harness

    env, threads = dict(os.environ), torch.get_num_threads()
    before = {m.split(".")[0] for m in sys.modules}
    own = lambda: sorted(({m.split(".")[0] for m in sys.modules} - before)
                         & harness.JAX_MODULES)
    traffic = registry.traffic

    def short(name, *a, **kw):
        return {**traffic(name, *a, **kw), "trace": {"skip_s": 0.0, "calls": 2},
                "warmup": {"min_calls": 2, "stable_calls": 2, "max_calls": 6}}

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()), \
                mock.patch.object(harness, "jax_loaded", own), \
                mock.patch.object(registry, "traffic", short):
            # a window of several calls even on a loaded host: the slice starts
            # at the window's second call
            rc = program_trace.main(["--workload", workload, "--seed", str(2**31 + 7),
                                     "--seconds", "4.0", "--rehearse", "--scale", "0.002"])
    finally:
        gc.unfreeze()
        os.environ.clear()
        os.environ.update(env)
        torch.set_num_threads(threads)
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])["program_trace"]


@pytest.mark.parametrize("workload", ["tpch-sf8-lineitem-q1q6.load",
                                      "tpch-sf4-table2.load"])
def test_a_rehearsed_traced_run_prints_the_program_metrics(workload):
    res, prog = rehearse_traced(workload)
    assert res["correct"] is True
    for name in READERS:
        assert res["metrics"][f"cpu_rehearsal.{name}"]["value"] >= 0
    if workload.startswith("tpch-sf8"):       # whole columns staged at registration
        assert res["metrics"]["cpu_rehearsal.stagings_built.load"]["value"] == 0
    traced = prog["traced_loads"]
    assert traced >= 1 and prog["device_ops_named_program"] == 0
    for part in ("plan", "run"):
        assert prog["in_harness"][part]["holding_one"] == traced
    assert prog["in_harness"]["run"]["least_share"] > 0.5
    # each profiled plan searched (plan.decide) or handed back the plan memo's
    # plan (plan.reuse); a hit takes microseconds, so the profiler's own time
    # around it may outweigh it: only a search has to cover most of its span
    kinds = prog["plan_kinds"]
    assert len(kinds) == traced and set(kinds) <= {"search", "reuse"}
    shares = prog["in_harness"]["plan"]["shares"]
    assert all(s > 0.5 for k, s in zip(kinds, shares, strict=True) if k == "search")
    assert {"repro_torch.plan", "repro_torch.run", "repro_torch.run.unit",
            "repro_torch.run.sync"} <= set(prog["steps"])
