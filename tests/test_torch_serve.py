"""The port's serving planner on the CPU, against the JAX reference's.

TPC-H at scale 0.002 (seed 0).  Each request ships its own blobs: encoded by
the reference, and handed to the port through ``encoded_from_reference``.  Both
packages' executors run with the reference's serving knobs (``"auto"`` chunks,
per-chunk decode, the adaptive policy) and, where their plans are compared,
cost models pinned to one chip as in ``tests/test_torch_planner.py``:

  * ``qualify``/``rid_of`` round-trip;
  * ``_plan_wave`` over the same registered columns and cost-model state
    gives the reference's order, chosen candidate, window and decisions, and
    its candidates' and requests' modeled times within 1e-12 relative, for
    the closed and SLO mixes under every policy, seeded and calibrated;
  * concurrent submissions decode in one wave bitwise as serial runs, as
    ``decode_np`` and as the reference's ``ServePlanner`` on the same blobs;
  * dedup, cross-request batching (``decode_launches`` and
    ``cross_batched_saved`` equal to the reference's), the modeled makespan
    against the naive composition, the SLO mix's point latency;
  * the executor's hooks: ``preempt`` called as often as the reference calls
    it on an equal plan, a nested ``run_one`` there bitwise, the outer
    columns' ``kernel_launches`` without the nested run's; ``on_ready`` once per
    column, batched members included; ``_preempt`` serves a late point request;
  * the drain loop, ``stop``, per-request wave errors, the per-name stores
    emptied after every wave, the constructor's refusals, and mesh waves.
"""
import collections
import dataclasses
import threading

import numpy as np
import pytest

from repro.core import costmodel as RC
from repro.core import plan as RP
from repro.core.compiler import ProgramCache as RefCache
from repro.core.executor import StreamingExecutor as RefExecutor
from repro.core.serve_planner import ServePlanner as RefPlanner
from repro.data.columns import TABLE2_PLANS as REF_PLANS

import torch

from repro_torch.core import costmodel as C
from repro_torch.core import plan as P
from repro_torch.core import serve_planner as S
from repro_torch.core.executor import StreamingExecutor
from repro_torch.core.serve_planner import ServePlanner, qualify, rid_of
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.loader import ColumnPipeline
from repro_torch.data.tpch import QUERY_COLUMNS, generate
from repro_torch.kernels.fully_parallel import KERNEL as FP

PIN = dict(hbm_gbps=3350.0, host_link_gbps=48.8, grid_step_overhead_ns=254_000.0)
REL = 1e-12
SERVE_KW = dict(chunk_bytes="auto", chunk_decode=True, policy="adaptive")
# name -> requests (rid, query columns, class)
MIXES = {
    "closed": [(f"r{i}", QUERY_COLUMNS[q], S.BULK) for i, q in enumerate((1, 6, 13, 1, 6, 13))],
    "slo": [("bulk", QUERY_COLUMNS[1], S.BULK), ("p0", ["O_ORDERKEY"], S.POINT),
            ("p1", ["O_ORDERKEY"], S.POINT), ("p2", ["O_ORDERKEY"], S.POINT)],
}
STORES = ("_encoded", "_programs", "_graphs", "_staged")
KEYED_STORES = ("_stagings", "_schedules")


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


def ref_executor(**kw):
    return RefExecutor(cache=RefCache(), cost_model=pinned(RC), **{**SERVE_KW, **kw})


def port_executor(**kw):
    return StreamingExecutor("torch", "cpu", cost_model=pinned(C), **{**SERVE_KW, **kw})


@pytest.fixture(scope="module")
def cols():
    return generate(0.002, seed=0)


def ref_blobs(cols, names):
    """Fresh blobs per call: distinct requests ship distinct buffers."""
    return {n: RP.encode(REF_PLANS[n], cols[n]) for n in names}


def port_blobs(rblobs):
    return {n: P.encoded_from_reference(e) for n, e in rblobs.items()}


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def mix_blobs(cols, mix):
    """Per request of a mix: (rid, reference blobs, port blobs, class)."""
    out = []
    for rid, names, klass in MIXES[mix]:
        rb = ref_blobs(cols, names)
        out.append((rid, rb, port_blobs(rb), klass))
    return out


def per_name_state(ex) -> set:
    """Every request-qualified name left in the executor's per-name stores."""
    left = set()
    for store in STORES:
        left |= {k for k in getattr(ex, store) if S.SEP in k}
    for store in KEYED_STORES:
        left |= {k[0] for k in getattr(ex, store) if S.SEP in k[0]}
    return left | {k for k in (*ex.cost_model.profiles, *ex.cost_model.measured) if S.SEP in k}


# ---------------------------------------------------------------- names

@pytest.mark.parametrize("rid,col", [("r1", "L_TAX"), ("r1", "weird/col"), ("7", "O_COMMENT")])
def test_qualify_roundtrip(rid, col):
    qn = qualify(rid, col)
    assert qn == f"{rid}/{col}" and rid_of(qn) == rid


def test_submit_refuses_a_rid_with_the_separator():
    sp = ServePlanner(port_executor())
    with pytest.raises(ValueError, match="must not contain"):
        sp.submit("a/b", {})
    sp.submit("a", {})
    with pytest.raises(ValueError, match="already pending"):
        sp.submit("a", {})


# ------------------------------------------------------------- _plan_wave

def registered(planner, blobs, which):
    """Submit a mix and register its union as ``_run_wave`` does; returns the
    arguments of ``_plan_wave``."""
    for rid, rb, pb, klass in blobs:
        planner.submit(rid, rb if which == "ref" else pb, klass=klass)
    reqs = list(planner._pending)
    planner._pending.clear()
    names, req_names, primary = [], {r.rid: [] for r in reqs}, {}
    for req in reqs:
        for col, enc in req.encs.items():
            qn = qualify(req.rid, col)
            p = primary.setdefault(id(enc), qn)
            if p == qn:
                names.append(qn)
                planner.executor.compile(qn, enc)
            req_names[req.rid].append(p)
    return reqs, names, req_names


@pytest.mark.parametrize("calibrated", (False, True), ids=("seeded", "calibrated"))
@pytest.mark.parametrize("policy", ("shared", "slo", "fifo-per-query"))
@pytest.mark.parametrize("mix", tuple(MIXES))
def test_plan_wave_equals_reference(mix, policy, calibrated, cols):
    blobs = mix_blobs(cols, mix)
    rp, pp = RefPlanner(ref_executor(), policy=policy), ServePlanner(port_executor(), policy=policy)
    rargs, pargs = registered(rp, blobs, "ref"), registered(pp, blobs, "port")
    assert rargs[1] == pargs[1]
    if calibrated:
        rng = np.random.default_rng(1)
        for n in pargs[1][::2]:
            t, d = rng.uniform(1e-5, 2e-3), rng.uniform(1e-5, 5e-3)
            rp.executor.cost_model.observe(n, t, d)
            pp.executor.cost_model.observe(n, t, d)
    rplan, rrep = rp._plan_wave(*rargs)
    plan, rep = pp._plan_wave(*pargs)
    assert plan.order == rplan.order and plan.policy == rplan.policy
    assert plan.window == rplan.window == rep.window == rrep.window
    assert {n: dataclasses.asdict(d) for n, d in plan.decisions.items()} == \
        {n: dataclasses.asdict(d) for n, d in rplan.decisions.items()}
    assert (rep.chosen, rep.order, rep.rids) == (rrep.chosen, rrep.order, rrep.rids)
    assert set(rep.candidates) == set(rrep.candidates)
    for got, want in ((rep.candidates, rrep.candidates),
                      (rep.modeled_finish_s, rrep.modeled_finish_s),
                      (rep.naive_finish_s, rrep.naive_finish_s)):
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=REL), k
    for got, want in ((rep.shared_makespan_s, rrep.shared_makespan_s),
                      (rep.naive_makespan_s, rrep.naive_makespan_s),
                      (plan.modeled_makespan_s, rplan.modeled_makespan_s)):
        assert got == pytest.approx(want, rel=REL)


# ------------------------------------------------- correctness under sharing

@pytest.fixture(scope="module")
def shared_waves(cols):
    """Four requests submitted from four threads and drained in one wave, by
    both packages, on the same blobs."""
    mp = pytest.MonkeyPatch()
    mp.setattr(RC, "native_subtile", subtile)
    mp.setattr(C, "native_subtile", subtile)
    try:
        mixes = [QUERY_COLUMNS[1], QUERY_COLUMNS[6], QUERY_COLUMNS[13], QUERY_COLUMNS[6]]
        rblobs = [ref_blobs(cols, names) for names in mixes]
        pblobs = [port_blobs(b) for b in rblobs]
        planner = ServePlanner(port_executor(), policy="shared")
        errs = []

        def submit(i):
            try:
                planner.submit(f"r{i}", pblobs[i])
            except Exception as e:          # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(mixes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        ref = RefPlanner(ref_executor(), policy="shared")
        for i, b in enumerate(rblobs):
            ref.submit(f"r{i}", b)
        return {"planner": planner, "done": planner.drain(), "ref": ref.drain(),
                "ref_report": ref.reports[-1], "pblobs": pblobs}
    finally:
        mp.undo()


@pytest.mark.parametrize("i", range(4))
def test_concurrent_submissions_bitwise_equal_serial_and_reference(i, shared_waves):
    done, pblobs = shared_waves["done"], shared_waves["pblobs"]
    assert set(done) == {f"r{k}" for k in range(4)}
    assert len(shared_waves["planner"].reports) == 1
    req = done[f"r{i}"]
    assert req.done and req.error is None and req.latency_s > 0
    serial = StreamingExecutor("torch", "cpu", **SERVE_KW)
    for n, e in pblobs[i].items():
        serial.compile(f"s/{n}", e)
    alone = serial.run()
    want = shared_waves["ref"][f"r{i}"]
    for n, enc in pblobs[i].items():
        got = bits(req.results[n].array.numpy())
        np.testing.assert_array_equal(got, bits(alone[f"s/{n}"].array.numpy()), err_msg=n)
        np.testing.assert_array_equal(got, bits(P.decode_np(enc)), err_msg=n)
        np.testing.assert_array_equal(got, bits(want.results[n].array), err_msg=n)


def test_shared_wave_accounting_equals_reference(shared_waves):
    rep, want = shared_waves["planner"].reports[-1], shared_waves["ref_report"]
    assert (rep.chosen, rep.order) == (want.chosen, want.order)
    assert rep.decode_launches == want.decode_launches
    assert rep.cross_batched_saved == want.cross_batched_saved
    assert rep.register_s > 0 and rep.makespan_s > 0 and rep.wall_s >= rep.makespan_s


def test_registration_split_covers_the_registration(shared_waves):
    rep = shared_waves["planner"].reports[0]
    split = rep.register_split_s
    assert set(split) == {"program", "profile", "schedule", "layout", "alloc", "pack"}
    assert min(split.values()) >= 0 and split["alloc"] > 0 and split["pack"] > 0
    assert sum(split.values()) <= rep.register_s


def test_per_name_state_is_dropped_after_every_wave(shared_waves, cols):
    planner = shared_waves["planner"]
    ex = planner.executor
    assert per_name_state(ex) == set()
    assert ex.cost_model.sig_stats             # the per-signature history survives
    planner.max_wave = 1
    for i in range(3):
        planner.submit(f"w{i}", port_blobs(ref_blobs(cols, QUERY_COLUMNS[6])))
    assert len(planner.drain()) == 3 and len(planner.reports) == 4
    assert per_name_state(ex) == set() and not ex._encoded
    assert ex.cache.stats["misses"] > 0


def test_dedup_identical_blob_decodes_once(cols):
    enc = port_blobs(ref_blobs(cols, ["L_TAX"]))["L_TAX"]
    planner = ServePlanner(port_executor(), policy="shared")
    planner.submit("a", {"L_TAX": enc})
    planner.submit("b", {"L_TAX": enc})
    done = planner.drain()
    ra, rb = done["a"].results["L_TAX"], done["b"].results["L_TAX"]
    assert ra is rb                      # one decode fanned out, not two
    np.testing.assert_array_equal(bits(ra.array.numpy()), bits(P.decode_np(enc)))


# ----------------------------------------------------- cross-request batching

def test_cross_request_batching_cuts_launches_as_the_reference(cols):
    """Same-signature columns of different requests decode in one batched
    unit under the shared plan; the naive server cannot do that."""
    mixes = [QUERY_COLUMNS[6], QUERY_COLUMNS[6], QUERY_COLUMNS[1]]
    reports = {}
    for label, (Planner, ex, convert) in {
            "port": (ServePlanner, port_executor, port_blobs),
            "ref": (RefPlanner, ref_executor, lambda b: b)}.items():
        shared = Planner(ex(), policy="shared")
        for i, names in enumerate(mixes):
            shared.submit(f"r{i}", convert(ref_blobs(cols, names)))
        done = shared.drain()
        naive = Planner(ex(), policy="fifo-per-query", max_wave=1)
        for i, names in enumerate(mixes):
            naive.submit(f"r{i}", convert(ref_blobs(cols, names)))
        naive.drain()
        reports[label] = (shared.reports[-1], sum(r.decode_launches for r in naive.reports),
                          done)
    rep, naive_launches, done = reports["port"]
    want = reports["ref"][0]
    assert rep.decode_launches < naive_launches
    assert rep.cross_batched_saved > 0
    assert rep.naive_makespan_s >= rep.shared_makespan_s
    assert (rep.decode_launches, rep.cross_batched_saved) == \
        (want.decode_launches, want.cross_batched_saved)
    groups = {frozenset((c,) + r.batched_with) for q in done.values()
              for c, r in q.results.items() if r.batched_with}
    assert any(len({rid_of(n) for n in g}) > 1 for g in groups)
    for req in done.values():
        for c, r in req.results.items():
            np.testing.assert_array_equal(bits(r.array.numpy()), bits(cols[c]), err_msg=c)


def test_shared_makespan_never_exceeds_naive_composition(cols):
    mixes = [QUERY_COLUMNS[1], QUERY_COLUMNS[13], QUERY_COLUMNS[6], QUERY_COLUMNS[6]]
    planner = ServePlanner(port_executor(), policy="shared")
    for i, names in enumerate(mixes):
        planner.submit(f"r{i}", port_blobs(ref_blobs(cols, names)))
    planner.drain()
    rep = planner.reports[-1]
    assert rep.shared_makespan_s <= rep.naive_makespan_s * (1 + 1e-9)
    assert rep.naive_makespan_s == pytest.approx(rep.candidates["fifo-per-query"])
    for i in range(len(mixes)):
        assert rep.modeled_finish_s[f"r{i}"] > 0 and rep.naive_finish_s[f"r{i}"] > 0
    assert max(rep.modeled_finish_s.values()) == pytest.approx(rep.shared_makespan_s)


# ------------------------------------------------------------ SLO + preempt

def test_slo_policy_bounds_point_latency_under_bulk(cols):
    planner = ServePlanner(port_executor(), policy="slo")
    planner.submit("bulk", port_blobs(ref_blobs(cols, QUERY_COLUMNS[1])), klass=S.BULK)
    planner.submit("pt", port_blobs(ref_blobs(cols, ["O_ORDERKEY"])), klass=S.POINT)
    done = planner.drain()
    rep = planner.reports[-1]
    assert rep.modeled_finish_s["pt"] <= rep.naive_finish_s["pt"] * (1 + 1e-9)
    assert rep.modeled_finish_s["pt"] < rep.modeled_finish_s["bulk"]
    for rid in ("bulk", "pt"):
        for c, rec in done[rid].results.items():
            np.testing.assert_array_equal(bits(rec.array.numpy()),
                                          bits(P.decode_np(done[rid].encs[c])))


@pytest.fixture(scope="module")
def preempted_runs(cols):
    """A bulk run (Q6's columns, 2 KiB chunks, per-chunk decode) whose preempt
    hook cuts in with a nested ``run_one`` at its first call, in both
    packages, on equal plans."""
    mp = pytest.MonkeyPatch()
    mp.setattr(RC, "native_subtile", subtile)
    mp.setattr(C, "native_subtile", subtile)
    try:
        kw = dict(chunk_bytes=1 << 11, chunk_decode=True, policy="chunk-johnson")
        rbulk = {f"bulk/{n}": e for n, e in ref_blobs(cols, QUERY_COLUMNS[6]).items()}
        rpt = ref_blobs(cols, ["O_ORDERKEY"])["O_ORDERKEY"]
        out = {}
        for label, ex, bulk, pt in (
                ("ref", RefExecutor(cache=RefCache(), cost_model=pinned(RC), **kw), rbulk, rpt),
                ("port", StreamingExecutor("torch", "cpu", cost_model=pinned(C), **kw),
                 port_blobs(rbulk), P.encoded_from_reference(rpt))):
            for n, e in bulk.items():
                ex.compile(n, e)
            plan = ex.plan(list(bulk))
            calls, nested = [0], {}

            def preempt(ex=ex, pt=pt, calls=calls, nested=nested):
                calls[0] += 1
                if calls[0] == 1:
                    nested["res"] = ex.run_one(pt, name="pt/O_ORDERKEY")

            res = (ex.run(bulk, plan=plan, preempt=preempt) if label == "ref"
                   else ex.run(plan=plan, preempt=preempt))
            out[label] = {"ex": ex, "plan": plan, "calls": calls[0], "res": res,
                          "nested": nested["res"], "bulk": bulk, "pt": pt}
        return out
    finally:
        mp.undo()


def test_preempt_hook_calls_equal_the_reference(preempted_runs):
    got, want = preempted_runs["port"], preempted_runs["ref"]
    assert got["plan"].order == want["plan"].order
    assert {n: d.decode_mode for n, d in got["plan"].decisions.items()} == \
        {n: d.decode_mode for n, d in want["plan"].decisions.items()}
    assert any(r.chunk_decoded for r in got["res"].values())
    assert got["calls"] == want["calls"] > len(got["res"])
    assert got["calls"] == sum(r.n_chunks if r.chunk_decoded else 1
                               for r in got["res"].values()) - 1


def test_nested_run_one_is_bitwise_and_unregistered(preempted_runs):
    got = preempted_runs["port"]
    np.testing.assert_array_equal(got["nested"].numpy(), P.decode_np(got["pt"]))
    np.testing.assert_array_equal(got["nested"].numpy(),
                                  np.asarray(preempted_runs["ref"]["nested"]))
    for qn, enc in got["bulk"].items():
        a = bits(got["res"][qn].array.numpy())
        np.testing.assert_array_equal(a, bits(P.decode_np(enc)), err_msg=qn)
        np.testing.assert_array_equal(a, bits(preempted_runs["ref"]["res"][qn].array),
                                      err_msg=qn)
    assert "pt/O_ORDERKEY" not in got["ex"]._encoded
    assert per_name_state(got["ex"]) == set(got["bulk"])


@pytest.mark.parametrize("mode", (False, True), ids=("inline", "async"))
def test_outer_kernel_launches_exclude_a_nested_run(mode, cols, monkeypatch):
    """Each unit's launches go to its own columns: a nested run between two
    units of an outer column is not counted in it.  On the CPU the plain
    versions launch nothing, so each decode unit counts one launch here, and
    the nested run a thousand more."""
    monkeypatch.setattr(FP, "launches", FP.launches)
    decode = StreamingExecutor._decode

    def one_launch(self, unit, flats, cols_):
        decode(self, unit, flats, cols_)
        FP.launches += 1

    monkeypatch.setattr(StreamingExecutor, "_decode", one_launch)
    ex = StreamingExecutor("torch", "cpu", chunk_bytes=1 << 13, chunk_decode=True,
                           policy="fifo")
    for n, e in port_blobs(ref_blobs(cols, QUERY_COLUMNS[1])).items():
        ex.compile(n, e)
    pt = port_blobs(ref_blobs(cols, ["O_ORDERKEY"]))["O_ORDERKEY"]
    nested = []

    def preempt():
        if len(nested) < 3:
            FP.launches += 1000
            nested.append(ex.run_one(pt, name=f"pt{len(nested)}/O_ORDERKEY"))

    res = ex.run(preempt=preempt, async_dispatch=mode)
    assert len(nested) == 3 and any(r.chunk_decoded for r in res.values())
    for n, r in res.items():
        units = r.n_chunks if r.chunk_decoded else 1
        assert r.kernel_launches == units, n
        np.testing.assert_array_equal(bits(r.array.numpy()), bits(cols[n]), err_msg=n)


def test_preemptive_wave_serves_a_late_point_request(cols):
    planner = ServePlanner(port_executor(), policy="slo")
    pt = port_blobs(ref_blobs(cols, ["O_ORDERKEY"]))
    planner.submit("pt-late", pt, klass=S.POINT)
    planner.submit("bulk-late", port_blobs(ref_blobs(cols, ["L_TAX"])), klass=S.BULK)
    planner._in_wave = True             # as if a bulk wave were mid-run
    try:
        planner._preempt()
    finally:
        planner._in_wave = False
    assert planner.pending == 1         # the bulk request waits for the next wave
    done = planner.drain()
    assert set(done) == {"pt-late", "bulk-late"}
    req = done["pt-late"]
    assert req.done and req.preempted_in and not done["bulk-late"].preempted_in
    np.testing.assert_array_equal(req.results["O_ORDERKEY"].array.numpy(),
                                  P.decode_np(pt["O_ORDERKEY"]))


def test_slo_wave_preempts_for_points_submitted_mid_wave(cols):
    """Points submitted at the bulk wave's first preempt call are served by
    one nested wave inside it, as ``chip_smoke.py`` drives it on the card."""
    planner = ServePlanner(port_executor(chunk_bytes=1 << 13), policy="slo")
    planner.submit("bulk", port_blobs(ref_blobs(cols, QUERY_COLUMNS[1])), klass=S.BULK)
    points = [port_blobs(ref_blobs(cols, ["O_ORDERKEY"])) for _ in range(3)]
    preempt = planner._preempt

    def arrive():
        if planner.pending == 0 and not planner._served:
            for i, b in enumerate(points):
                planner.submit(f"p{i}", b, klass=S.POINT)
        preempt()

    planner._preempt = arrive
    done = planner.drain()
    bulk_rep = next(r for r in planner.reports if r.rids == ("bulk",))
    assert bulk_rep.preempted == 3
    assert all(done[f"p{i}"].preempted_in for i in range(3))
    for req in done.values():
        assert req.error is None
        for c, r in req.results.items():
            np.testing.assert_array_equal(bits(r.array.numpy()), bits(cols[c]), err_msg=c)


@pytest.mark.parametrize("mode", (False, True), ids=("inline", "async"))
def test_on_ready_fires_once_per_column_batched_members_included(mode, cols):
    pipe = ColumnPipeline({c: TABLE2_PLANS[c] for c in QUERY_COLUMNS[1]}, device="cpu")
    pipe.compress({c: cols[c] for c in QUERY_COLUMNS[1]})
    ready = []
    res = pipe.executor.run(on_ready=ready.append, async_dispatch=mode)
    assert collections.Counter(ready) == collections.Counter(QUERY_COLUMNS[1])
    assert any(r.batched_with for r in res.values())
    assert ready == list(res)        # in decode order: the plan's issue order


# ------------------------------------------------------------- drain loop

def test_drain_loop_is_live(cols):
    rb = ref_blobs(cols, ["L_RETURNFLAG", "L_TAX"])
    sp = ServePlanner(port_executor()).start()
    try:
        reqs = [sp.submit(f"r{i}", port_blobs(rb)) for i in range(3)]
        for r in reqs:
            assert r.wait(timeout=300.0), f"{r.rid} never completed"
            assert r.error is None
            for c in rb:
                np.testing.assert_array_equal(bits(r.results[c].array.numpy()),
                                              bits(cols[c]), err_msg=c)
    finally:
        sp.stop()
    assert sp.pending == 0 and sp.reports
    assert sp._drain_thread is None


def test_stop_completes_in_flight_work_and_restarts(cols):
    rb = ref_blobs(cols, ["L_ORDERKEY"])
    sp = ServePlanner(port_executor()).start()
    reqs = [sp.submit(f"w{i}", port_blobs(rb)) for i in range(4)]
    sp.stop()                       # work in flight; the join includes the final sweep
    for r in reqs:
        assert r.done and r.error is None, r.rid
        np.testing.assert_array_equal(r.results["L_ORDERKEY"].array.numpy(),
                                      cols["L_ORDERKEY"])
    assert sp.pending == 0
    sp.start()
    again = sp.submit("again", port_blobs(rb))
    assert again.wait(timeout=120.0) and again.error is None
    sp.stop()
    assert per_name_state(sp.executor) == set()


def test_wave_errors_surface_per_request(cols, monkeypatch):
    sp = ServePlanner(port_executor())
    boom = RuntimeError("wave exploded")
    run_wave = sp._run_wave
    monkeypatch.setattr(sp, "_run_wave", lambda wave, preemptive=False: (_ for _ in ()).throw(boom))
    bad = [sp.submit(f"b{i}", port_blobs(ref_blobs(cols, ["L_TAX"]))) for i in range(2)]
    done = sp.drain()
    assert set(done) == {"b0", "b1"}
    assert all(r.done and r.error is boom and r.wait(0) for r in bad)
    monkeypatch.setattr(sp, "_run_wave", run_wave)
    good = sp.submit("g", port_blobs(ref_blobs(cols, ["L_TAX"])))
    assert sp.drain()["g"] is good and good.error is None
    np.testing.assert_array_equal(good.results["L_TAX"].array.numpy(), cols["L_TAX"])


def test_a_failed_registration_unregisters_what_it_registered(cols, monkeypatch):
    sp = ServePlanner(port_executor())
    ex = sp.executor
    compile_ = ex.compile

    def failing(name, enc):
        if name.endswith("L_TAX"):
            raise ValueError("bad blob")
        return compile_(name, enc)

    monkeypatch.setattr(ex, "compile", failing)
    req = sp.submit("r", port_blobs(ref_blobs(cols, ["L_DISCOUNT", "L_TAX"])))
    sp.drain()
    assert isinstance(req.error, ValueError)
    assert per_name_state(ex) == set()


# ------------------------------------------------------- construction

def test_serve_planner_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServePlanner()


@pytest.mark.parametrize("kw", [dict(mesh=2), dict(mesh=4), dict(placement="sharded")])
def test_mesh_and_placement_planners_serve_a_wave(kw, cols):
    """``mesh > 1`` spreads a wave over that many devices (all on the host
    here); ``placement`` alone serves a plain wave, as in the reference."""
    sp = ServePlanner(port_executor(), **kw)
    names = ["L_DISCOUNT", "L_TAX", "L_RETURNFLAG"]
    req = sp.submit("r", port_blobs(ref_blobs(cols, names)))
    sp.drain()
    assert req.error is None
    for c in names:
        np.testing.assert_array_equal(bits(req.results[c].array.numpy()), bits(cols[c]))
    rep = sp.reports[-1]
    if "mesh" in kw:
        assert rep.chosen.startswith("mesh:")
        assert rep.devices == tuple(range(kw["mesh"]))
        assert rep.device_launches and rep.makespan_s > 0
    else:
        assert not rep.chosen.startswith("mesh:") and rep.devices == ()
    assert per_name_state(sp.executor) == set()


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown serve policy"):
        ServePlanner(port_executor(), policy="lifo")


def test_pipeline_serve_planner_shares_its_executor(cols):
    names = QUERY_COLUMNS[6]
    pipe = ColumnPipeline({c: TABLE2_PLANS[c] for c in names}, device="cpu")
    sp = pipe.serve_planner(policy="slo", max_wave=2)
    assert sp.executor is pipe.executor and sp.policy == "slo" and sp.max_wave == 2
    req = pipe.encode_request({c: cols[c] for c in names})
    for c in names:
        want = P.encode(TABLE2_PLANS[c], cols[c])
        assert req[c].buffers.keys() == want.buffers.keys()
        for k in want.buffers:
            np.testing.assert_array_equal(req[c].buffers[k], want.buffers[k])
    r = sp.submit("q6", req)
    sp.drain()
    for c in names:
        np.testing.assert_array_equal(bits(r.results[c].array.numpy()), bits(cols[c]))


def test_concurrent_submitters_and_the_drain_thread_lose_nothing(cols):
    """More submitting threads than cores against the drain thread, with a
    shortened switch interval: every request is served exactly once, none
    fails, and every column is bitwise its source."""
    import os
    import sys

    blobs = port_blobs(ref_blobs(cols, ["L_TAX", "L_LINESTATUS"]))
    sp = ServePlanner(port_executor(chunk_bytes=None)).start(poll_s=0.001)
    n_threads, per = 2 * (os.cpu_count() or 4), 3
    reqs, errs = [], []
    lock = threading.Lock()
    barrier = threading.Barrier(n_threads)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def submitter(t):
            barrier.wait(timeout=60)
            for i in range(per):
                try:
                    r = sp.submit(f"t{t}x{i}", dict(blobs))
                except Exception as e:          # pragma: no cover
                    errs.append(e)
                    continue
                with lock:
                    reqs.append(r)

        threads = [threading.Thread(target=submitter, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errs
        for r in reqs:
            assert r.wait(timeout=300.0), r.rid
    finally:
        sys.setswitchinterval(interval)
        sp.stop()
    assert len(reqs) == n_threads * per == len({r.rid for r in reqs})
    served = [rid for rep in sp.reports for rid in rep.rids]
    assert sorted(served) == sorted(r.rid for r in reqs)      # each exactly once
    for r in reqs:
        assert r.error is None
        for c in blobs:
            np.testing.assert_array_equal(bits(r.results[c].array.numpy()), bits(cols[c]))
    assert per_name_state(sp.executor) == set()
