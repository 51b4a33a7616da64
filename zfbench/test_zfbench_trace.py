"""The trace's arithmetic and the metric readers on a synthetic run."""
import pytest

from zfbench.lib import registry
from zfbench.lib.harness import Run
from zfbench.lib.trace import H2D, KERNEL, DeviceOp, HostEvent, Trace, device_kind


def synthetic_trace():
    dev = [DeviceOp("Memcpy HtoD (Pinned -> Device)", H2D, 0, 40, 4000),
           DeviceOp("zf_kernel", KERNEL, 30, 60, 0),      # overlaps the copy
           DeviceOp("Memcpy HtoD (Pinned -> Device)", H2D, 80, 90, 1000)]
    host = [HostEvent("zfbench.run", 0, 95), HostEvent("aten::copy_", 62, 70),
            HostEvent("zfbench.plan", 100, 120)]
    return Trace(device=dev, host=host, t0=0, t1=120)


def test_busy_is_a_union_and_gaps_are_named():
    tr = synthetic_trace()
    assert tr.busy_intervals() == [(0, 60), (80, 90)]
    assert tr.busy_s == pytest.approx(70e-9)
    assert tr.idle_gaps() == [(60, 80), (90, 120)]
    assert tr.host_at([66, 75, 97, 110]) == ["run/aten::copy_", "run/python",
                                              "between calls", "plan/python"]
    b = tr.breakdown()
    assert b["device_ops"][0] == ["Memcpy HtoD (Pinned -> Device)", 50e-9]
    assert dict(map(tuple, b["idle_gaps"])) == {"run/aten::copy_": 20e-9,
                                                "plan/python": 30e-9}


def test_device_kinds():
    assert device_kind("Memcpy DtoH (Device -> Pageable)") == "memcpy_d2h"
    assert device_kind("Memcpy DtoD (Device -> Device)") == "memcpy_d2d"
    assert device_kind("Memset (Device)") == "memset"
    assert device_kind("void zf_qg_kernel<P>(A)") == KERNEL


def run_of(calls, trace=None):
    return Run(workload="w", config={}, traffic={}, device_kind="NVIDIA H100 80GB HBM3",
               setup_s=12.5, window_s=2.0, calls=calls, trace=trace,
               counted={"compressed": {"A": 100, "B": 50}, "plain": {"A": 400, "B": 200}})


def test_readers_on_a_synthetic_run():
    loads = [{"op": "load", "t0": i, "t1": i + 0.01 * (i + 1), "plain_bytes": 10**9,
              "decode_units": 3 + i % 2, "issue_s": 0.002, "makespan_s": 0.004,
              "traced": i < 2} for i in range(10)]
    run = run_of(loads, synthetic_trace())
    read = lambda name: registry.metric_reader(name)(run, name)
    assert read("load_GBps") == pytest.approx(5.0)
    assert read("load_ms.p95") == pytest.approx(95.5)
    assert read("setup_s") == 12.5
    assert read("decode_units.load") == pytest.approx(3.5)
    assert read("issue_ms.load") == pytest.approx(2.0)
    assert read("device_makespan_ms.load") == pytest.approx(4.0)
    assert read("h2d_GBps.load") == pytest.approx(5000 / 50)
    assert read("device_idle.load") == pytest.approx(100 * 50 / 120)
    # 2 traced loads x 750 bytes at 3.35e12 B/s over the 30 ns kernel
    assert read("decode_roofline.load") == pytest.approx(100 * 1500 / 3.35e12 / 30e-9)
    assert read("queries_per_s") is None and read("query_chunks.query") is None


def test_readers_without_a_trace_read_nothing():
    run = run_of([{"op": "query", "query": "q6", "t0": 0, "t1": 0.01, "n_chunks": 2,
                   "makespan_s": 0.008}])
    for name in ("h2d_GBps.query", "device_idle.query", "query_roofline.query"):
        assert registry.metric_reader(name)(run, name) is None
    assert registry.metric_reader("queries_per_s")(run, "queries_per_s") == 0.5
