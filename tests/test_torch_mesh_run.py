"""The port's mesh executor (``StreamingExecutor.run_sharded``) on the CPU,
against the JAX reference's on 4 forced host devices.

The reference runs once per module in a subprocess
(``tests/torch_mesh_ranks.py ref_mesh_run``, ``XLA_FLAGS`` forcing 4 devices
before JAX starts) on the columns of ``tests/test_mesh_decode.py``; its mesh
plans, shard schedules and results come back pickled.  The port takes the
same blobs (``encoded_from_reference``) and the reference's own plans,
carried over field for field, onto a CPU executor whose 4 logical devices
all map onto the host (``devices[id % len(devices)]``).  Every comparison is
exact:

  * every shard's range schedule (``shard_schedule``) equals the reference's
    at N = 2 and 4, an interior shard's last span included;
  * ``run_sharded`` sequential and concurrent: every column bitwise the
    reference's and the source, ``per_device``, ``device_launches`` and
    ``shard_devices`` the reference's; ``concurrent=None`` takes the
    concurrent path only when the legs with work sit on more than one
    physical device (never on the host or one card); each leg feeds
    ``observe_link``;
  * the skewed-link fabric plan's D2D legs: bitwise, the executed legs the
    plan's and the reference's, ``shard_devices`` the final placement, the
    fabric EWMA seeded;
  * the elastic suffix after the loss of device 0 runs on the survivors only,
    bitwise; a mesh serving wave over 2 devices serves bitwise;
  * the engine over several legs: 4 legs under one host-staging slot
    complete; a failing transfer or D2D worker surfaces as
    ``RuntimeError("transfer worker failed")`` and leaves no thread behind,
    a D2D worker's while the legs are still being driven;
  * ``_assemble_shards``: co-located shards concatenate, equal-size shards on
    distinct devices stay a ``ShardedColumn`` (also out of ``run_sharded``
    with the logical devices mapped onto four distinct ones).
"""
import dataclasses
import pickle
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import costmodel as C
from repro_torch.core import executor as E
from repro_torch.core import plan as P
from repro_torch.core import planner as PL
from repro_torch.core.executor import ShardedColumn, StreamingExecutor
from repro_torch.core.serve_planner import ServePlanner

import torch_mesh_ranks as R

SERVE_KW = dict(chunk_bytes="auto", chunk_decode=True)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_run")
    R.run_case("ref_mesh_run", str(d))
    with open(d / "ref_mesh_run.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def blobs():
    cols, rencs = R.mesh_blobs()
    return cols, {n: P.encoded_from_reference(e) for n, e in rencs.items()}


def executor(blobs) -> StreamingExecutor:
    ex = StreamingExecutor("torch", "cpu", **SERVE_KW)
    for n, e in blobs[1].items():
        ex.compile(n, e)
    return ex


def port_plan(rmp) -> PL.MeshExecutionPlan:
    """A reference ``MeshExecutionPlan`` as the port's, field for field."""
    def dec(d):
        return PL.ColumnDecision(**dataclasses.asdict(d))

    plans = tuple(PL.ExecutionPlan(order=tuple(p.order),
                                   decisions={n: dec(d) for n, d in p.decisions.items()},
                                   policy=p.policy, window=p.window,
                                   modeled_makespan_s=p.modeled_makespan_s,
                                   baselines=dict(p.baselines)) for p in rmp.plans)
    return PL.MeshExecutionPlan(
        n_devices=rmp.n_devices, device_ids=tuple(rmp.device_ids), plans=plans,
        assignment=dict(rmp.assignment),
        shards={c: tuple(PL.ShardSpec(**dataclasses.asdict(s)) for s in ss)
                for c, ss in rmp.shards.items()},
        policy=rmp.policy, window=rmp.window, modeled_makespan_s=rmp.modeled_makespan_s,
        baselines=dict(rmp.baselines),
        topology=C.LinkTopology(**dataclasses.asdict(rmp.topology)),
        placement=dict(rmp.placement), redistribution=tuple(rmp.redistribution),
        placement_policy=rmp.placement_policy)


def schedule_fields(s) -> dict:
    return {f: getattr(s, f) for f in ("out_starts", "out_sizes", "whole", "kind",
                                       "g_starts", "g_sizes", "pad_sizes", "axes",
                                       "row_caps")} | {
        "slices": {k: [tuple(map(int, p)) for p in v] for k, v in s.slices.items()},
        "host_push": sorted(s.host_push), "n_chunks": s.n_chunks}


def mesh_threads() -> list[str]:
    return [t.name for t in threading.enumerate() if t.name.startswith("zipflow-")]


def assert_run_equal(res, want: dict, cols: dict) -> None:
    for c, a in want["arrays"].items():
        np.testing.assert_array_equal(res[c].array.numpy(), a, err_msg=c)
        np.testing.assert_array_equal(res[c].array.numpy(), cols[c], err_msg=c)
    assert res.per_device == want["per_device"]
    assert res.device_launches == want["device_launches"]
    assert {c: res[c].shard_devices for c in res.plan.shards} == want["shard_devices"]


@pytest.fixture(scope="module")
def runs(ref, blobs):
    """The reference's N = 4 plan, run sequentially and concurrently on one
    port executor."""
    ex = executor(blobs)
    mp = port_plan(ref["plans"]["n4"])
    return {"ex": ex, "plan": mp,
            "seq": ex.run_sharded(mp, concurrent=False),
            "conc": ex.run_sharded(mp, concurrent=True)}


# ------------------------------------------------------------ schedules

@pytest.mark.parametrize("n", (2, 4))
def test_shard_schedules_equal_the_reference(n, ref, blobs):
    ex = executor(blobs)
    scheds = {it: v for (m, it), v in ref["schedules"].items() if m == n}
    mp = ref["plans"][f"n{n}"]
    assert sorted(scheds) == sorted(s.name for ss in mp.shards.values() for s in ss)
    assert len(mp.shards["big"]) == n
    interior_tail = 0
    for it, (cb, want) in scheds.items():
        col = PL.shard_column_of(it)
        spec = next(s for s in mp.shards[col] if s.name == it)
        got = ex.shard_schedule(col, cb, spec.g_lo, spec.g_hi)
        assert schedule_fields(got) == schedule_fields(want), it
        assert got.g_starts[0] == spec.g_lo and sum(got.g_sizes) == spec.n_groups
        assert sum(got.out_sizes) == spec.n_out
        assert ex.shard_schedule(col, cb, spec.g_lo, spec.g_hi) is got    # built once
        interior_tail += spec.g_hi < mp.shards[col][-1].g_hi
    assert interior_tail > 0        # an interior shard's last span is among them


def test_a_shard_of_a_packed_leaf_starts_at_its_first_bit(ref, blobs):
    """The string dictionary's bit-packed index: an interior shard's spans
    start inside a word, and their pieces are shifted there on the host."""
    ex = executor(blobs)
    spec = ref["plans"]["n4"].shards["sdbp"][1]
    cb = ref["schedules"][(4, spec.name)][0]
    sched = ex.shard_schedule("sdbp", cb, spec.g_lo, spec.g_hi)
    leaf = "root/index.packed"
    assert any(sched.bit_offsets[leaf])
    words = P.host_operands(ex._encoded["sdbp"])[leaf]
    bw = int(P.host_operands(ex._encoded["sdbp"])["root/index.@bit_width"][0])
    for k, r in enumerate(sched.bit_offsets[leaf]):
        lo, hi = sched.slices[leaf][k]
        assert r == sched.g_starts[k] * bw % 32
        piece = sched.piece(words, leaf, k)
        bits = np.unpackbits(words.view(np.uint8), bitorder="little")
        want = np.packbits(bits[lo * 32 + r:lo * 32 + r + (hi - lo) * 32 - 32],
                           bitorder="little").view(np.uint32)
        np.testing.assert_array_equal(piece[:len(want)], want)


def test_whole_column_schedules_are_unchanged(blobs):
    """Without a range, the group schedule is the whole column's: forced
    only for shards, never misaligned."""
    ex = executor(blobs)
    for n in ("big", "rle", "sdbp"):
        for cb in (1 << 10, 1 << 12):
            s = ex.chunk_schedule(n, cb)
            if s is not None:
                assert s.g_starts[0] == 0 and s.bit_offsets == {}
                assert schedule_fields(ex._build_group_schedule(n, cb)) == schedule_fields(s)


# ------------------------------------------------------------ run_sharded

@pytest.mark.parametrize("mode", ("seq", "conc"))
def test_run_sharded_equals_the_reference(mode, runs, ref, blobs):
    res = runs[mode]
    assert_run_equal(res, ref["runs"][mode], blobs[0])
    assert len(set(res["big"].shard_devices)) > 1
    assert set(res.device_launches) == set(range(4))
    assert runs["ex"].physical_devices() == [torch.device("cpu")]
    assert res.makespan_s > 0 and set(res.leg_makespan_s) == set(range(4))
    spans = 0
    for s in res.plan.shards["big"]:
        d = next(p.decisions[s.name] for p in res.plan.plans if s.name in p.decisions)
        spans += runs["ex"].shard_schedule("big", d.chunk_bytes, s.g_lo, s.g_hi).n_chunks
    assert res["big"].chunk_decoded and res["big"].n_chunks == spans
    assert mesh_threads() == []


def test_concurrent_equals_sequential(runs):
    for c in runs["plan"].columns():
        np.testing.assert_array_equal(runs["conc"][c].array.numpy(),
                                      runs["seq"][c].array.numpy(), err_msg=c)
        assert runs["conc"][c].n_chunks == runs["seq"][c].n_chunks


def column_array(arr) -> np.ndarray:
    return (arr if isinstance(arr, torch.Tensor) else arr.full()).numpy()


def spy_concurrent(monkeypatch) -> list:
    called = []
    real = StreamingExecutor._drive_concurrent

    def spy(self, *a, **kw):
        called.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(StreamingExecutor, "_drive_concurrent", spy)
    return called


def test_default_is_sequential_on_one_physical_device(runs, monkeypatch):
    """Four legs with work, all on the host: the default runs them one after
    another; ``concurrent=True`` still asks for the concurrent path, except
    when only one leg has work."""
    ex, mp = runs["ex"], runs["plan"]
    called = spy_concurrent(monkeypatch)
    res = ex.run_sharded(mp)
    assert called == []
    ex.run_sharded(mp, concurrent=True)
    assert called == [1]
    one = dataclasses.replace(mp, plans=(mp.plans[0],) + tuple(
        dataclasses.replace(p, order=()) for p in mp.plans[1:]))
    ex.run_sharded(one, concurrent=True)          # one leg with work: inline
    assert called == [1]
    for c in mp.columns():
        np.testing.assert_array_equal(res[c].array.numpy(), runs["seq"][c].array.numpy())


def on_devices(ex, n: int) -> list:
    """``ex``'s logical devices mapped onto ``n`` distinct physical ones."""
    devs = [torch.device("cpu", i) for i in range(n)]
    ex.physical_devices = lambda: devs
    return devs


def test_default_is_concurrent_when_several_legs_have_work(runs, blobs, monkeypatch):
    """Four legs with work on two distinct physical devices: the default
    takes the concurrent path, bitwise the sequential one."""
    ex, mp = executor(blobs), runs["plan"]
    on_devices(ex, 2)
    called = spy_concurrent(monkeypatch)
    res = ex.run_sharded(mp)
    assert called == [1]
    for c in mp.columns():
        np.testing.assert_array_equal(column_array(res[c].array),
                                      runs["seq"][c].array.numpy(), err_msg=c)
    assert res.per_device == runs["seq"].per_device
    assert mesh_threads() == []


def test_equal_shards_on_four_devices_come_back_sharded(runs, blobs):
    """On four distinct physical devices the string dictionary's four
    equal shards stay a ``ShardedColumn`` on their devices, in index order;
    uneven shards are joined; every column bitwise the sequential run."""
    ex, mp = executor(blobs), runs["plan"]
    devs = on_devices(ex, 4)
    res = ex.run_sharded(mp)
    got = res["sdbp"].array
    assert isinstance(got, ShardedColumn)
    assert got.devices == tuple(devs[d] for d in res["sdbp"].shard_devices)
    assert got.starts == tuple(int(x) for x in np.cumsum(
        [0] + [s.n_out for s in mp.shards["sdbp"]][:-1]))
    assert isinstance(res["big"].array, torch.Tensor)     # uneven shards
    for c in mp.columns():
        np.testing.assert_array_equal(column_array(res[c].array),
                                      runs["seq"][c].array.numpy(), err_msg=c)


@pytest.mark.parametrize("concurrent", (False, True))
def test_each_leg_feeds_observe_link(concurrent, runs, monkeypatch):
    ex, mp = runs["ex"], runs["plan"]
    links, observed = [], []
    monkeypatch.setattr(ex.cost_model, "observe_link",
                        lambda link, ratio: links.append((link, ratio)))
    real = ex.cost_model.observe
    monkeypatch.setattr(ex.cost_model, "observe",
                        lambda n, t, d: (observed.append(n), real(n, t, d)))
    ex.run_sharded(mp, concurrent=concurrent)
    assert sorted(link for link, _ in links) == [0, 1, 2, 3]
    assert all(r > 0 for _, r in links)
    assert not any(PL.SHARD_SEP in n for n in observed)     # shards feed no column timing


# ------------------------------------------------------------- D2D legs

@pytest.mark.parametrize("concurrent", (False, True))
def test_d2d_legs_equal_the_plan_and_the_reference(concurrent, ref, blobs):
    ex = executor(blobs)
    assert not ex.cost_model.topology.has_fabric
    mp = port_plan(ref["plans"]["fabric"])
    assert mp.redistribution
    res = ex.run_sharded(mp, concurrent=concurrent)
    assert_run_equal(res, ref["runs"]["fabric"], blobs[0])
    legs = {it: (src, dst) for it, src, dst in mp.redistribution}
    assert set(res.d2d_copies) == set(legs) == set(ref["runs"]["fabric"]["d2d"])
    for it, (src, dst, secs) in res.d2d_copies.items():
        assert (src, dst) == (mp.device_ids[legs[it][0]], mp.device_ids[legs[it][1]])
        assert (src, dst) == ref["runs"]["fabric"]["d2d"][it]
        assert src != dst and secs >= 0.0
    for col, specs in mp.shards.items():
        assert res[col].shard_devices == tuple(
            int(mp.device_ids[mp.final_device(s.name)]) for s in specs), col
    assert ex.cost_model.topology.has_fabric
    assert mesh_threads() == []


# ------------------------------------------------------- elastic, serving

def test_elastic_suffix_runs_on_the_survivors(runs, ref, blobs):
    mp2 = port_plan(ref["plans"]["suffix"])
    assert mp2.device_ids == (1, 2, 3)
    res = runs["ex"].run_sharded(mp2)
    assert_run_equal(res, ref["runs"]["suffix"], blobs[0])
    assert set(res.per_device) <= {1, 2, 3}
    done = [it for it in ref["runs"]["seq"]["per_device"][0] if PL.SHARD_SEP not in it]
    assert not set(done) & set(mp2.columns())


def test_a_mesh_serving_wave(ref, blobs):
    cols, encs = blobs
    sp = ServePlanner(StreamingExecutor("torch", "cpu", **SERVE_KW), mesh=2)
    sp.submit("q1", {"big": encs["big"], "small0": encs["small0"]})
    sp.submit("q2", {"rle": encs["rle"], "small1": encs["small1"]})
    served = sp.drain()
    rep = sp.reports[-1]
    assert rep.chosen.startswith("mesh:") and ref["serve"]["chosen"].startswith("mesh:")
    assert rep.devices == ref["serve"]["devices"] == (0, 1)
    assert rep.device_launches and set(rep.device_launches) <= set(rep.devices)
    assert rep.register_s > 0 and rep.makespan_s > 0 and rep.register_split_s
    for rid, r in served.items():
        assert r.error is None
        for c, rec in r.results.items():
            np.testing.assert_array_equal(rec.array.numpy(), cols[c])
            np.testing.assert_array_equal(rec.array.numpy(),
                                          ref["serve"]["arrays"][f"{rid}/{c}"])


# ------------------------------------------------ the engine over several legs

def test_four_legs_complete_under_one_host_slot(runs):
    ex, mp = runs["ex"], runs["plan"]
    tight = dataclasses.replace(mp, topology=dataclasses.replace(mp.topology, host_window=1))
    res = ex.run_sharded(tight, concurrent=True)
    for c in mp.columns():
        np.testing.assert_array_equal(res[c].array.numpy(), runs["seq"][c].array.numpy())
    assert mesh_threads() == []


def test_drive_round_robins_synthetic_legs_under_one_slot():
    """Four generators, each needing its items in order, on four workers
    sharing one staging slot: every leg ends, no more than one held item is
    committed and unconsumed at a time, and each leg's value comes back."""
    engine = E.DispatchEngine(host_window=1)
    lock, state = threading.Lock(), {"held": 0, "peak": 0}

    def issue(i):
        with lock:
            state["held"] += 1
            state["peak"] = max(state["peak"], state["held"])

    def leg(key, iss, n):
        iss.advance(n)
        for u in range(n):
            yield ("need", u + 1)
            with lock:
                state["held"] -= 1
        return key

    try:
        tasks = {}
        for k in range(4):
            iss = engine.issuer(issue, 5, held=[True] * 5, name=f"zipflow-xfer-d{k}")
            tasks[k] = (leg(k, iss, 5), iss)
        assert engine.drive(tasks) == {k: k for k in range(4)}
    finally:
        engine.close()
    assert state == {"held": 0, "peak": 1}
    assert mesh_threads() == []


@pytest.mark.parametrize("where", ("transfer", "d2d"))
def test_a_failing_worker_on_one_leg_stops_the_run(where, ref, blobs, monkeypatch):
    ex = executor(blobs)
    mp = port_plan(ref["plans"]["fabric"])
    boom = OSError("copy failed")
    if where == "transfer":
        issue = E._HostLeg.issue

        def failing(leg, u):
            if leg.device == torch.device("cpu") and any("rle" in n for n in leg.cols) \
                    and u == 1:
                raise boom
            issue(leg, u)

        monkeypatch.setattr(E._HostLeg, "issue", failing)
    else:
        def failing(self, leg):
            raise boom

        monkeypatch.setattr(StreamingExecutor, "_d2d_copy", failing)
    with pytest.raises(RuntimeError, match="transfer worker failed") as info:
        ex.run_sharded(mp, concurrent=True)
    assert info.value.__cause__ is boom
    assert mesh_threads() == []


def test_drive_surfaces_a_d2d_worker_while_a_leg_waits():
    """A D2D issuer that is no task's fails while the only leg waits for an
    item its worker holds back: ``drive`` raises at once, before the leg's
    item is committed."""
    engine = E.DispatchEngine()
    release, boom = threading.Event(), OSError("copy failed")

    def slow(i):
        release.wait(timeout=30.0)

    def failing(i):
        raise boom

    def leg(iss):
        iss.advance(1)
        yield ("need", 1)

    try:
        iss = engine.issuer(slow, 1, name="zipflow-xfer-d0")
        d2d = engine.issuer(failing, 1, name="zipflow-d2d-x", sync=True)
        d2d.advance(1)
        with pytest.raises(RuntimeError, match="transfer worker failed") as info:
            engine.drive({0: (leg(iss), iss)})
        assert info.value.__cause__ is boom
        assert iss.committed == 0
    finally:
        release.set()
        engine.close()
    assert mesh_threads() == []


# ------------------------------------------------------------- assembly

def test_co_located_shards_concatenate():
    a, b = torch.arange(4, dtype=torch.int32), torch.arange(4, 10, dtype=torch.int32)
    cpu = torch.device("cpu")
    got = StreamingExecutor._assemble_shards([a, b], [cpu, cpu])
    assert isinstance(got, torch.Tensor)
    torch.testing.assert_close(got, torch.cat([a, b]), rtol=0, atol=0)
    assert StreamingExecutor._assemble_shards([a], [cpu]) is a


def test_equal_shards_on_distinct_devices_stay_sharded():
    shards = [torch.arange(i * 5, i * 5 + 5, dtype=torch.int32) for i in range(4)]
    devs = [torch.device("cpu", i) for i in range(4)]
    got = StreamingExecutor._assemble_shards(shards, devs)
    assert isinstance(got, ShardedColumn)
    assert got.devices == tuple(devs) and got.starts == (0, 5, 10, 15)
    torch.testing.assert_close(got.full(), torch.cat(shards), rtol=0, atol=0)
    uneven = StreamingExecutor._assemble_shards(shards[:3] + [shards[3][:2]], devs)
    assert isinstance(uneven, torch.Tensor) and uneven.numel() == 17
