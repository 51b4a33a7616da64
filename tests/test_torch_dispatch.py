"""The port's dispatch engine on the CPU, against its inline path and the
JAX reference's ``run(..., async_dispatch=True)``.

On the reference's mixed column set (whole, element-chunked, group-chunked and
RLE span columns), encoded once by the reference and handed to both packages:

  * a run through the transfer thread (``async_dispatch=True``) is bitwise the
    inline run on the same plan, and both are the source;
  * the tightest host-staging budget (``host_window=1``) completes, with at
    most one per-chunk-decode chunk staged and not yet decoded at a time;
  * both issuers keep the window: unit u's copies are issued only once the
    decode of unit u - window has run;
  * the constructor's knob and ``ColumnPipeline(async_dispatch=)`` pass through;
  * a failing copy surfaces as ``RuntimeError("transfer worker failed")``, and
    no ``zipflow-xfer`` thread outlives a run;
  * the port's async run gives bitwise the reference's async run of an equal
    plan (both cost models pinned as in ``tests/test_torch_planner.py``), with
    equal ``n_chunks``, ``decode_launches``, ``chunk_decoded`` and
    ``batched_with``.
"""
import dataclasses
import threading

import numpy as np
import pytest

from repro.core import costmodel as RC
from repro.core import plan as RP
from repro.core.compiler import ProgramCache as RefCache
from repro.core.executor import StreamingExecutor as RefExecutor

from repro_torch.core import costmodel as C
from repro_torch.core import executor as E
from repro_torch.core import plan as P
from repro_torch.core.executor import StreamingExecutor
from repro_torch.data.loader import ColumnPipeline

PIN = dict(hbm_gbps=3350.0, host_link_gbps=48.8, grid_step_overhead_ns=254_000.0)
NAMES = ("whole", "elem", "grp", "rle")


def subtile(pattern: str, chip: str = "", itemsize: int = 4) -> int:
    return {"fp": 1024, "gp": 1024, "np": 64}.get(pattern, 1024)


@pytest.fixture(autouse=True)
def same_subtile(monkeypatch):
    monkeypatch.setattr(RC, "native_subtile", subtile)
    monkeypatch.setattr(C, "native_subtile", subtile)


def pinned(mod):
    cm = mod.CostModel()
    cm.spec = dataclasses.replace(cm.spec, **PIN)
    return cm


@pytest.fixture(scope="module")
def columns():
    """The reference's mixed set: whole, element-chunked, group-chunked, RLE."""
    rng = np.random.default_rng(11)
    cols = {
        "whole": rng.integers(0, 9, 3_000).astype(np.int32),
        "elem": (np.arange(200_000, dtype=np.int32) % 1000),
        "grp": np.concatenate([np.zeros(50_000, np.int32),
                               rng.integers(0, 60, 30_000).astype(np.int32)]),
        "rle": np.repeat(rng.integers(0, 50, 400),
                         rng.integers(1, 90, 400)).astype(np.int32),
    }
    plans = {"whole": RP.Plan("ans", params={"chunk_size": 512}),
             "elem": RP.make_plan("bitpack"),
             "grp": RP.Plan("ans", params={"chunk_size": 512}),
             "rle": RP.make_plan("rle")}
    return {n: RP.encode(plans[n], a) for n, a in cols.items()}, cols


def executor(encs, **kw) -> StreamingExecutor:
    kw.setdefault("chunk_bytes", 1 << 14)
    kw.setdefault("chunk_decode", True)
    ex = StreamingExecutor("torch", "cpu", **kw)
    for n, e in encs.items():
        ex.compile(n, P.encoded_from_reference(e))
    return ex


def xfer_threads() -> list[str]:
    return [t.name for t in threading.enumerate() if t.name == "zipflow-xfer"]


@pytest.fixture(scope="module")
def both_modes(columns):
    encs, _ = columns
    ex = executor(encs)
    plan = ex.plan()
    return {mode: ex.run(plan=plan, async_dispatch=mode) for mode in (False, True)}


def test_the_plan_covers_both_decode_regimes(both_modes):
    recs = both_modes[False].values()
    assert any(r.chunk_decoded for r in recs) and any(not r.chunk_decoded for r in recs)
    assert any(r.decode_launches > 1 for r in recs)


@pytest.mark.parametrize("name", NAMES)
def test_worker_issuance_bitwise_equal_to_inline(name, both_modes, columns):
    _, cols = columns
    seq, asy = both_modes[False][name], both_modes[True][name]
    np.testing.assert_array_equal(asy.array.numpy(), seq.array.numpy())
    np.testing.assert_array_equal(asy.array.numpy(), cols[name])
    assert (asy.n_chunks, asy.decode_launches, asy.chunk_decoded) == \
        (seq.n_chunks, seq.decode_launches, seq.chunk_decoded)


def test_tightest_host_budget_completes_and_holds_one_chunk(columns, monkeypatch):
    """``host_window=1``: one shared staging slot; the run completes bitwise,
    and no per-chunk-decode chunk is issued while another one is staged and
    not yet decoded."""
    encs, cols = columns
    ex = executor(encs)
    ex.cost_model.topology = dataclasses.replace(ex.cost_model.topology, host_window=1)
    state = {"issued": 0, "decoded": 0, "peak": 0}
    issue, decode = E._HostLeg.issue, StreamingExecutor._decode

    def counting_issue(leg, u):
        if leg.cols[leg.units[u].members[0]]["sched"] is not None:
            state["peak"] = max(state["peak"], state["issued"] - state["decoded"])
            state["issued"] += 1
        issue(leg, u)

    def counting_decode(self, unit, flats, cols_):
        decode(self, unit, flats, cols_)
        if cols_[unit.members[0]]["sched"] is not None:
            state["decoded"] += 1

    monkeypatch.setattr(E._HostLeg, "issue", counting_issue)
    monkeypatch.setattr(StreamingExecutor, "_decode", counting_decode)
    res = ex.run(async_dispatch=True)
    for n in NAMES:
        np.testing.assert_array_equal(res[n].array.numpy(), cols[n], err_msg=n)
    assert state["issued"] == state["decoded"] > 1
    assert state["peak"] == 0


@pytest.mark.parametrize("window", (1, 2, 3))
@pytest.mark.parametrize("mode", ("inline", "async"))
def test_issuers_hold_the_window(mode, window, columns, monkeypatch):
    """Unit u's copies are issued only once the decode of unit u - window has
    run, by either issuer: the window as a host watermark."""
    encs, cols = columns
    ex = executor(encs)
    decoded, ahead = [0], []
    issue, decode = E._HostLeg.issue, StreamingExecutor._decode

    def watching_issue(leg, u):
        ahead.append(u - decoded[0])
        issue(leg, u)

    def counting_decode(self, unit, flats, cols_):
        decode(self, unit, flats, cols_)
        decoded[0] += 1

    monkeypatch.setattr(E._HostLeg, "issue", watching_issue)
    monkeypatch.setattr(StreamingExecutor, "_decode", counting_decode)
    res = ex.run(window=window, async_dispatch=mode == "async")
    for n in NAMES:
        np.testing.assert_array_equal(res[n].array.numpy(), cols[n], err_msg=n)
    assert len(ahead) == decoded[0] > window
    assert max(ahead) <= window - 1
    if mode == "inline":            # the inline issuer fills the window at once
        assert max(ahead) == window - 1


def test_constructor_knob_and_pipeline_pass_through(columns, monkeypatch):
    encs, cols = columns
    ex = executor(encs, async_dispatch=True)
    assert ex.async_dispatch
    started = []
    real = E.DispatchEngine.issuer

    def spy(self, *a, **kw):
        started.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(E.DispatchEngine, "issuer", spy)
    res = ex.run()              # no per-call override: the constructor's knob rules
    assert started == [1]
    ex.run(async_dispatch=False)
    assert started == [1]
    for n in NAMES:
        np.testing.assert_array_equal(res[n].array.numpy(), cols[n], err_msg=n)
    pipe = ColumnPipeline({"a": P.make_plan("bitpack")}, device="cpu", chunk_bytes=4096,
                          async_dispatch=True)
    assert pipe.async_dispatch and pipe.executor.async_dispatch
    assert not ColumnPipeline({"a": P.make_plan("bitpack")}, device="cpu").async_dispatch


def test_a_failing_copy_surfaces_at_the_dispatcher(columns, monkeypatch):
    encs, _ = columns
    ex = executor(encs)
    boom = OSError("copy failed")
    issue = E._HostLeg.issue

    def failing(leg, u):
        if u == 2:
            raise boom
        issue(leg, u)

    monkeypatch.setattr(E._HostLeg, "issue", failing)
    with pytest.raises(RuntimeError, match="transfer worker failed") as info:
        ex.run(async_dispatch=True)
    assert info.value.__cause__ is boom
    assert xfer_threads() == []
    with pytest.raises(OSError):            # the inline path raises it as it is
        ex.run(async_dispatch=False)


@pytest.mark.parametrize("mode", (False, True))
def test_no_transfer_thread_outlives_a_run(mode, columns):
    encs, cols = columns
    ex = executor(encs)
    res = ex.run(async_dispatch=mode)
    assert xfer_threads() == []
    np.testing.assert_array_equal(res["grp"].array.numpy(), cols["grp"])
    assert ex.last_issue_s > 0
    assert ex.last_wait_s >= 0 if mode else ex.last_wait_s == 0.0


@pytest.fixture(scope="module")
def against_reference(columns):
    """The reference's and the port's executors over the same blobs with
    pinned cost models; each plans its own (equal) plan and runs it through
    its dispatch engine."""
    encs, _ = columns
    mp = pytest.MonkeyPatch()
    mp.setattr(RC, "native_subtile", subtile)
    mp.setattr(C, "native_subtile", subtile)
    try:
        kw = dict(chunk_bytes=1 << 14, chunk_decode=True)
        rex = RefExecutor(cache=RefCache(), cost_model=pinned(RC), **kw)
        for n, e in encs.items():
            rex.compile(n, e)
        ex = executor(encs, cost_model=pinned(C), **kw)
        rplan, plan = rex.plan(list(encs)), ex.plan()
        return {"rplan": rplan, "plan": plan,
                "ref": rex.run(encs, plan=rplan, async_dispatch=True),
                "got": ex.run(plan=plan, async_dispatch=True)}
    finally:
        mp.undo()


def test_async_plans_equal_the_reference(against_reference):
    r = against_reference
    assert r["plan"].order == r["rplan"].order
    assert {n: dataclasses.asdict(d) for n, d in r["plan"].decisions.items()} == \
        {n: dataclasses.asdict(d) for n, d in r["rplan"].decisions.items()}
    assert r["plan"].window == r["rplan"].window


@pytest.mark.parametrize("name", NAMES)
def test_async_run_bitwise_equal_to_the_reference(name, against_reference, columns):
    _, cols = columns
    got, want = against_reference["got"][name], against_reference["ref"][name]
    np.testing.assert_array_equal(got.array.numpy(), np.asarray(want.array))
    np.testing.assert_array_equal(got.array.numpy(), cols[name])
    assert (got.n_chunks, got.decode_launches, got.chunk_decoded) == \
        (want.n_chunks, want.decode_launches, want.chunk_decoded)
    assert got.batched_with == tuple(want.batched_with)


def test_async_runs_stay_bitwise_under_a_short_switch_interval(columns):
    """The transfer thread and the dispatcher switched every 10 µs: each run
    is still the source, bit for bit, whatever the window."""
    import sys

    encs, cols = columns
    ex = executor(encs)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for window in (1, 2, 4, 8):
            res = ex.run(window=window, async_dispatch=True)
            for n in NAMES:
                np.testing.assert_array_equal(res[n].array.numpy(), cols[n], err_msg=n)
    finally:
        sys.setswitchinterval(interval)
    assert xfer_threads() == []
