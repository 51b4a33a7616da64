"""The open-loop ``serve`` kind (``lib/serve.py``): its schedule, its latency
from the scheduled arrival, its readers, and rehearsed runs on the CPU."""
import contextlib
import gc
import io
import json
import os
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

from zfbench.faults import run_with_fault
from zfbench.lib import registry, serve
from zfbench.lib.harness import Run
from zfbench.lib.trace import H2D, KERNEL, DeviceOp, HostEvent, Trace

SERVE = "tpch-sf4-table2.serve"
TRAFFIC = registry.traffic("serve")
PER_LAYER = ("register_ms.serve", "wave_requests.serve", "wave_ms.serve",
             "device_idle.serve", "h2d_GBps.serve")


def test_the_mix_is_data_the_cell_can_serve():
    bench = registry.with_held(registry.benchmark())
    cfg = registry.config(bench, registry.cell(bench, SERVE)["config"])
    columns = {c for cols in cfg["tables"].values() for c in cols}
    assert TRAFFIC["loop"] == "open" and TRAFFIC["rate_per_s"] > 0
    assert list(TRAFFIC["queries"]) == ["Q1", "Q6", "Q13"]
    assert all(set(cols) <= columns for cols in TRAFFIC["queries"].values())
    assert {m["name"] for m in registry.cell_metrics(bench, SERVE, False)} == {
        "request_ms.p50", "setup_s"}
    assert [m["name"] for m in registry.cell_metrics(bench, SERVE, True)] == list(PER_LAYER)


def test_the_schedule_is_the_seeds_and_offers_every_seed_the_same_work():
    draw = lambda seed: serve.schedule(12.5, 200, 16.0, TRAFFIC["queries"],
                                       serve._rng(seed, 1))
    (a, qa), (b, qb), (c, qc) = draw(2**31 + 5), draw(2**31 + 5), draw(2**31 + 6)
    assert np.array_equal(a, b) and qa == qb
    assert qa != qc and sorted(qa) == sorted(qc)         # the same requests, reordered ...
    gaps = lambda offsets: np.diff(np.append(offsets, 16.0))
    assert not np.array_equal(a, c)                      # ... at other arrivals, bursts elsewhere ...
    assert np.allclose(np.sort(gaps(a)), np.sort(gaps(c)))   # ... from the same set of gaps
    assert a[0] == 0 and np.all(np.diff(a) > 0) and a[-1] < 16.0
    assert {q: qa.count(q) for q in set(qa)} == {"Q1": 67, "Q6": 67, "Q13": 66}
    # the gaps are an exponential distribution's (mean 16 s / 200), not even
    assert gaps(a).mean() == pytest.approx(0.08)
    assert gaps(a).std() == pytest.approx(0.08, rel=0.1)


class _StubServer:
    """Completes every request 1 ms after it is submitted; the first submit
    of the window stalls for ``stall_s`` first."""

    def __init__(self, stall_s: float):
        from repro_torch.core.serve_planner import ServeRequest

        self.make = ServeRequest
        self.stall_s = stall_s
        self.missed: set = set()

    def submit(self, rid, query):
        if rid == f"{serve.WINDOW}0":
            time.sleep(self.stall_s)
        req = self.make(rid=rid, encs={}, submitted_at=time.perf_counter())
        req.latency_s = 1e-3
        req._finish()
        return req


def p95_ms(recs):
    run = Run(workload=SERVE, config={}, traffic={}, device_kind="cpu", setup_s=1.0,
              window_s=1.0, calls=recs, trace=None, counted={})
    return registry.metric_reader("request_ms.p95")(run, "request_ms.p95")


def test_a_stalled_submitter_shows_in_the_latency():
    traffic = {**TRAFFIC, "rate_per_s": 40.0, "grace_s": 1.0}
    quick, stalled = (serve.window(_StubServer(s), traffic, 0.5, 7, False, False)[0]
                      for s in (0.0, 0.3))
    assert len(quick) == len(stalled) == 20
    assert all(r["t1"] - r["t0"] >= r["submitted"] - r["t0"] >= 0 for r in stalled)
    assert p95_ms(quick) < 50
    # the requests due during the stall were submitted late, and count it
    assert p95_ms(stalled) > 150
    assert sum(r["submitted"] - r["t0"] > 0.1 for r in stalled) >= 3


def test_serve_readers_on_a_synthetic_run():
    waves = [{"op": "wave", "requests": n, "register_s": 0.01 * n, "wall_s": 0.05 * n,
              "makespan_s": 0.0, "traced": n == 9} for n in (1, 2, 3, 9)]
    reqs = [{"op": "request", "t0": 0.0, "t1": 0.001 * (i + 1)} for i in range(100)]
    reqs.append({"op": "request", "t0": 0.0, "t1": None})          # never completed
    dev = [DeviceOp("Memcpy HtoD (Pinned -> Device)", H2D, 0, 40, 4000),
           DeviceOp("zf_kernel", KERNEL, 30, 60, 0)]
    tr = Trace(device=dev, host=[HostEvent("zfbench.run", 0, 100)], t0=0, t1=100)
    run = Run(workload=SERVE, config={}, traffic={}, device_kind="cpu", setup_s=1.0,
              window_s=1.0, calls=reqs + waves, trace=tr, counted={})
    read = lambda name: registry.metric_reader(name)(run, name)
    assert read("request_ms.p50") == pytest.approx(50.5)
    assert read("request_ms.p95") == pytest.approx(95.05)
    assert read("register_ms.serve") == pytest.approx(20.0)
    assert read("wave_requests.serve") == pytest.approx(2.0)
    assert read("wave_ms.serve") == pytest.approx(100.0)
    assert read("device_idle.serve") == pytest.approx(40.0)
    assert read("h2d_GBps.serve") == pytest.approx(100.0)
    empty = Run(workload=SERVE, config={}, traffic={}, device_kind="cpu", setup_s=1.0,
                window_s=1.0, calls=[], trace=None, counted={})
    assert all(registry.metric_reader(n)(empty, n) is None
               for n in ("request_ms.p50",) + PER_LAYER)


def test_a_rehearsed_serve_run_is_correct():
    res = run_with_fault(SERVE, None, seed=2**31 + 3, scale=0.005, seconds=1.5)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] == 6
    assert set(res["metrics"]) == {"cpu_rehearsal.request_ms.p50", "cpu_rehearsal.setup_s"}
    assert list(res["checks"]) == ["missing_columns", "mismatched_elements",
                                   "missing_answers", "lost_requests"]
    assert all(v["value"] == 0 for v in res["checks"].values())
    assert res["window"]["checked_requests"] >= 3
    assert list(res)[-1] == "checks"


def test_a_rehearsed_traced_serve_run_prints_its_layers():
    """Per-layer metrics of a traced run; the device's two read nothing on
    the CPU, which has no device operations to trace."""
    from zfbench import run as runner
    from zfbench.lib import harness

    env, threads = dict(os.environ), torch.get_num_threads()
    before = {m.split(".")[0] for m in sys.modules}
    own = lambda: sorted(({m.split(".")[0] for m in sys.modules} - before)
                         & harness.JAX_MODULES)
    traffic, benchmark = registry.traffic, registry.benchmark

    def short(name, *a, **kw):
        # the profiler slows the CPU's plain backend by seconds a wave
        return {**traffic(name, *a, **kw), "rate_per_s": 4.0, "grace_s": 60.0,
                "trace": {"requests": 2},
                "warmup": {"requests": 3, "quiet_requests": 1, "max_requests": 12}}

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()), \
                mock.patch.object(harness, "jax_loaded", own), \
                mock.patch.object(registry, "traffic", short), \
                mock.patch.object(registry, "benchmark",
                                  lambda *a, **kw: registry.with_held(benchmark(*a, **kw))):
            rc = runner.main(["--workload", SERVE, "--seed", str(2**31 + 9), "--seconds",
                              "0.75", "--trace", "1", "--rehearse", "--scale", "0.002"])
    finally:
        gc.unfreeze()
        os.environ.clear()
        os.environ.update(env)
        torch.set_num_threads(threads)
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {f"cpu_rehearsal.{n}" for n in PER_LAYER[:3]}
    assert res["metrics"]["cpu_rehearsal.wave_requests.serve"]["value"] >= 1
    assert res["breakdown"]["idle_gaps"]          # the drain thread's spans name them


# The load cells as the closed-loop path printed them before the open loop
# came: the same metric names and checks.
LOAD_NAMES = {
    "tpch-sf4-table2.load": {"load_GBps", "setup_s"},
    "tpch-sf8-lineitem-q1q6.load": {"load_GBps", "load_ms.p95", "setup_s"},
}


@pytest.mark.parametrize("cell", sorted(LOAD_NAMES))
def test_the_load_cells_print_what_they_printed(cell):
    res = run_with_fault(cell, None, seed=2**31 + 4)
    assert res["correct"] is True
    assert set(res["metrics"]) == {f"cpu_rehearsal.{n}" for n in LOAD_NAMES[cell]}
    assert list(res["checks"]) == ["missing_columns", "mismatched_elements",
                                   "missing_answers"]


def test_the_collector_keeps_the_seeds_sample_of_each_query():
    """Every query of the mix is among the requests checked."""
    traffic = {**TRAFFIC, "rate_per_s": 60.0, "grace_s": 1.0}

    class Keeping(_StubServer):
        def submit(self, rid, query):
            req = super().submit(rid, query)
            req.results = {"c": mock.Mock(array=query)}
            return req

    _, kept, late, _, _ = serve.window(Keeping(0.0), traffic, 0.5, 11, False, False)
    assert not late
    assert sorted(a["c"] for _, a in kept) == ["Q1", "Q13", "Q6"]
    assert [names for names, _ in kept] == [TRAFFIC["queries"][a["c"]] for _, a in kept]
