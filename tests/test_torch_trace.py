"""The port's spans (``core/trace.py``) and its staging counter, on the CPU:
no span without a profiler, every span of a plan and a run under one, each
inside its parent, and ``StreamingExecutor.stagings_built``."""
import collections
import dataclasses
import types

import pytest
import torch

from repro_torch.core import trace
from repro_torch.core.planner import BATCHED
from repro_torch.data import tpch
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.loader import ColumnPipeline
from repro_torch.kernels import cuda

COLUMNS = ("L_DISCOUNT", "L_TAX", "L_SHIPDATE")    # two batched, one per chunk
PARENT = {"plan.decide": "plan", "plan.order": "plan", "plan.window": "plan",
          "run.prepare": "run", "run.stage": "run.prepare", "run.issue": "run",
          "run.unit": "run", "run.decode": "run.unit", "run.sync": "run"}
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module")
def data():
    return tpch.generate(0.002, 0)


def pipeline(data) -> ColumnPipeline:
    pipe = ColumnPipeline({c: TABLE2_PLANS[c] for c in COLUMNS}, device="cpu",
                          chunk_bytes=1024, chunk_decode=True, policy="fifo")
    pipe.compress({c: data[c] for c in COLUMNS})
    return pipe


def mixed_plan(pipe: ColumnPipeline, chunk_bytes: int):
    """L_SHIPDATE decoded per chunk of ``chunk_bytes``; L_DISCOUNT and L_TAX
    whole, in one batched unit."""
    plan = pipe.plan(chunk_bytes=chunk_bytes)
    dec = dict(plan.decisions)
    for n in COLUMNS[:2]:
        dec[n] = dataclasses.replace(dec[n], decode_mode=BATCHED, chunk_bytes=None,
                                     n_chunks=1)
    return dataclasses.replace(plan, decisions=dec)


def program_events(prof) -> list[tuple[str, int, int]]:
    return [(e.name()[len(trace.PREFIX):], e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(trace.PREFIX)]


def decode_units(out) -> int:
    batches = {frozenset((r.name, *r.batched_with)) for r in out.values() if r.batched_with}
    return sum(r.decode_launches for r in out.values() if not r.batched_with) + len(batches)


def test_span_is_one_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    first = trace.span("run")
    assert trace.span("plan.decide") is first
    with first as entered:
        assert entered is None


def test_nothing_is_recorded_before_the_profiler_starts(data):
    pipe = pipeline(data)
    plan = mixed_plan(pipe, 2048)
    pipe.run(plan=plan)
    with torch.profiler.profile(activities=CPU) as prof:
        torch.ones(8).sum()
    assert program_events(prof) == []
    with torch.profiler.profile(activities=CPU) as prof:
        pipe.run(plan=plan)
    assert {n for n, _, _ in program_events(prof)} >= {"run", "run.unit"}


def test_every_span_of_a_plan_and_a_run_nests_in_its_parent(data):
    pipe = pipeline(data)
    before = pipe.executor.stagings_built
    with torch.profiler.profile(activities=CPU) as prof:
        plan = mixed_plan(pipe, 2048)
        out = pipe.run(plan=plan)
    evs = program_events(prof)
    names = collections.Counter(n for n, _, _ in evs)
    assert set(names) == {"plan", "run", *PARENT}      # no kernel launch on the CPU
    assert names["plan"] == names["run"] == names["run.prepare"] == names["run.sync"] == 1
    for name, a, b in evs:
        if name in PARENT:
            assert any(p == PARENT[name] and pa <= a and b <= pb for p, pa, pb in evs), name
    # one unit span per decode unit: 10 chunks of L_SHIPDATE and one batch
    assert [r.batched_with for r in out.values() if r.name != "L_SHIPDATE"] \
        == [("L_TAX",), ("L_DISCOUNT",)]
    assert names["run.unit"] == names["run.decode"] == decode_units(out) == 11
    # a staging for L_SHIPDATE at a new chunk size, and the two columns' whole ones
    assert names["run.stage"] == pipe.executor.stagings_built - before == 3
    with torch.profiler.profile(activities=CPU) as prof:
        pipe.run(plan=plan)
    names = collections.Counter(n for n, _, _ in program_events(prof))
    assert "run.stage" not in names and names["run.unit"] == 11


def test_a_reused_plan_records_plan_reuse_inside_its_plan_span(data):
    """Of two identical plans, the second hands back the first's search: its
    ``repro_torch.plan`` holds one ``plan.reuse`` and no search step."""
    pipe = pipeline(data)
    with torch.profiler.profile(activities=CPU) as prof:
        pipe.plan()
        pipe.plan()
    evs = program_events(prof)
    plans = sorted((a, b) for n, a, b in evs if n == "plan")
    assert len(plans) == 2

    def inside(name, span):
        return [e for e in evs if e[0] == name and span[0] <= e[1] and e[2] <= span[1]]

    assert not inside("plan.reuse", plans[0]) and inside("plan.decide", plans[0])
    assert len(inside("plan.reuse", plans[1])) == 1
    assert not inside("plan.decide", plans[1]) and not inside("plan.order", plans[1])
    assert (pipe.executor.plans_built, pipe.executor.plans_reused) == (1, 1)


@pytest.mark.parametrize("chunk_bytes", [2048, 4096])
def test_stagings_built_counts_what_a_run_at_a_new_chunk_size_builds(data, chunk_bytes):
    pipe = pipeline(data)
    ex = pipe.executor
    assert ex.stagings_built == len(COLUMNS)      # one a column at registration
    plan = mixed_plan(pipe, chunk_bytes)
    hosts = {id(s.host) for s in ex._stagings.values()}
    pipe.run(plan=plan)
    new_hosts = {id(s.host) for s in ex._stagings.values()} - hosts
    assert ex.stagings_built - len(COLUMNS) == len(new_hosts) == 3
    pipe.run(plan=plan)
    assert ex.stagings_built - len(COLUMNS) == 3


def test_a_kernel_launch_is_a_span(monkeypatch):
    lib = cuda.KernelLib("fake", "zf_fake", cuda.ZfFpArgs)
    seen = []

    def entry(*args):
        seen.append(len(args))
        return 0

    lib._lib = types.SimpleNamespace(zf_fake=entry)
    lib._batched, lib.batch_max = entry, 2
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    dev = torch.device("cuda", 0)
    with torch.profiler.profile(activities=CPU) as prof:
        lib.launch(cuda.ZfFpArgs(), 128, dev)
        lib.launch_batched([cuda.ZfFpArgs()] * 3, 128, dev)   # split 2 + 1
    assert seen == [4, 5, 5]
    assert [n for n, _, _ in program_events(prof)] == ["launch"] * 3
    assert lib.launches == 3 and lib.batched_launches == 2
