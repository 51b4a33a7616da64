"""The port's planner stack against the JAX reference's, on the CPU.

  * profiles: ``costmodel.profile_from`` equals the reference's field by field
    (``group_out_presum`` elementwise) on all 24 Table-2 columns at scale 0.002
    and on the ``rle`` and ``deltastride`` candidate plans of the key columns;
  * cost model: with both chip specs pinned to the same ``hbm_gbps``,
    ``host_link_gbps`` and ``grid_step_overhead_ns`` and ``native_subtile``
    replaced by one function in both modules, the same observations give equal
    ``raw_estimate``, ``predict``, ``jobs``, ``launch_overhead_s`` and
    ``chunk_ladder``; ``save``/``load`` round-trips;
  * plans: ``plan_execution`` gives equal ``ExecutionPlan``s for the four
    policies x ``chunk_bytes`` None, 256, 4096 and ``"auto"`` x
    ``chunk_decode``, before and after calibration: order, decisions, window
    and policy equal, the modeled makespan and the baselines within 1e-12
    relative (they are expected to be bit-identical);
  * runs: the same plan run by both executors (the port on the CPU, the
    reference on ``jnp``) gives bitwise-equal columns and equal ``n_chunks``,
    ``decode_launches``, ``chunk_decoded`` and ``batched_with``; so do the
    constructor's ``pipeline`` and ``prefetch_chunks`` knobs;
  * batched decode: ``Program.batched`` (and the kernels' batched wrappers on
    CPU tensors) equals K single calls, for the kernel-1 pair L_DISCOUNT +
    L_TAX, two RLE columns of one structure whose runs differ and two rANS
    columns of one shape; ``KernelLib.launch_batched`` splits a batch at the
    library's limit, which ``KernelLib.load`` reads from the library as it
    loads every kernel on the device once.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import costmodel as RC
from repro.core import plan as RP
from repro.core import planner as RPL
from repro.core.compiler import ProgramCache as RefCache
from repro.core.compiler import build_graph as ref_build_graph
from repro.core.executor import StreamingExecutor as RefExecutor
from repro.data.columns import TABLE2_PLANS as REF_PLANS

from repro_torch.core import costmodel as C
from repro_torch.core import plan as P
from repro_torch.core import planner as PL
from repro_torch.core.compiler import ProgramCache, build_graph, device_buffers
from repro_torch.core.executor import StreamingExecutor
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.loader import ColumnPipeline
from repro_torch.data.tpch import generate
from repro_torch.kernels import cuda, ref
from repro_torch.kernels.ops import run_stage_batched

COLUMNS = tuple(TABLE2_PLANS)
KEY_CANDIDATES = tuple(f"{c}/{p}" for c in ("L_ORDERKEY", "O_ORDERKEY", "PS_PARTKEY")
                       for p in ("rle", "deltastride"))
# the port's seeded H100 entries, given to both chip specs
PIN = dict(hbm_gbps=3350.0, host_link_gbps=48.8, grid_step_overhead_ns=254_000.0)
POLICIES = ("fifo", "johnson", "chunk-johnson", "adaptive")
CHUNK_BYTES = (None, 256, 4096, "auto")
REL = 1e-12


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def subtile(pattern: str, chip: str = "", itemsize: int = 4) -> int:
    """One chunk-ladder tile for both packages (their chips' geometries differ)."""
    return {"fp": 1024, "gp": 1024, "np": 64}.get(pattern, 1024)


@pytest.fixture(autouse=True)
def same_subtile(monkeypatch):
    monkeypatch.setattr(RC, "native_subtile", subtile)
    monkeypatch.setattr(C, "native_subtile", subtile)


def pinned(mod, cm=None):
    cm = cm or mod.CostModel()
    cm.spec = dataclasses.replace(cm.spec, **PIN)
    return cm


@pytest.fixture(scope="module")
def cols():
    return {k: v for k, v in generate(0.002, seed=0).items() if k in TABLE2_PLANS}


@pytest.fixture(scope="module")
def ref_encs(cols):
    encs = {k: RP.encode(REF_PLANS[k], cols[k]) for k in COLUMNS}
    for name in KEY_CANDIDATES:
        col, plan = name.split("/")
        encs[name] = RP.encode(RP.make_plan(plan), cols[col])
    return encs


@pytest.fixture(scope="module")
def profiles(ref_encs):
    """name -> (reference profile, port profile), each from its own graph."""
    out = {}
    for name, renc in ref_encs.items():
        penc = P.encoded_from_reference(renc)
        out[name] = (RC.profile_from(name, renc, ref_build_graph(renc)),
                     C.profile_from(name, penc, build_graph(penc)))
    return out


def observations(names, seed=0):
    rng = np.random.default_rng(seed)
    return [(n, float(t), float(d)) for n, t, d in
            zip(names, rng.uniform(1e-5, 2e-3, len(names)), rng.uniform(1e-5, 5e-3, len(names)))]


def models(profiles, observe: bool):
    """The reference's and the port's cost models, pinned, profiles registered,
    fed the same observations when ``observe``."""
    rcm, pcm = pinned(RC), pinned(C)
    for rp, pp in profiles.values():
        rcm.register(rp)
        pcm.register(pp)
    if observe:
        names = list(profiles)
        for name, t, d in observations(names[::3]):
            rcm.observe(name, t, d)
            pcm.observe(name, t, d)
    return rcm, pcm


# ---------------------------------------------------------------- profiles

@pytest.mark.parametrize("name", COLUMNS + KEY_CANDIDATES)
def test_profile_equals_reference(name, profiles):
    want, got = profiles[name]
    for f in dataclasses.fields(RC.ColumnProfile):
        if f.name == "group_out_presum":
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    if want.group_out_presum is None:
        assert got.group_out_presum is None
    else:
        np.testing.assert_array_equal(got.group_out_presum, want.group_out_presum)
    for cb in (None, 256, 4096, 1 << 16, 1 << 20):
        assert got.n_transfer_chunks(cb) == want.n_transfer_chunks(cb)
        assert got.decode_chunking(cb) == want.decode_chunking(cb)
        assert got.chunk_weights(cb) == want.chunk_weights(cb)


def test_profiles_reach_every_kind(profiles):
    """The set covers element-chunkable, group-span (gp and np) and whole-only
    graphs, so the comparisons above see every branch of ``profile_from``."""
    got = [p for _, p in profiles.values()]
    assert any(p.chunkable for p in got)
    assert {p.pattern for p in got if p.group_chunkable} >= {"gp", "np"}
    assert any(not p.chunkable and not p.group_chunkable for p in got)


# -------------------------------------------------------------- cost model

@pytest.mark.parametrize("observe", (False, True))
def test_cost_model_equals_reference(observe, profiles):
    rcm, pcm = models(profiles, observe)
    names = list(profiles)
    for name in names:
        rp, pp = profiles[name]
        assert pcm.raw_estimate(name) == rcm.raw_estimate(name)
        assert pcm.predict(name) == rcm.predict(name)
        assert pcm.launch_overhead_s(name) == rcm.launch_overhead_s(name)
        assert pcm.chunk_ladder(pp) == rcm.chunk_ladder(rp)
        assert pcm.fused_decode_s(name) == rcm.fused_decode_s(name)
        assert pcm.query_read_s(name) == rcm.query_read_s(name)
    jobs = [(j.name, j.transfer_s, j.decompress_s) for j in pcm.jobs(names)]
    assert jobs == [(j.name, j.transfer_s, j.decompress_s) for j in rcm.jobs(names)]
    assert (pcm.transfer_scale, pcm.decode_scale, pcm.n_observed) == \
        (rcm.transfer_scale, rcm.decode_scale, rcm.n_observed)
    assert pcm.sig_stats == rcm.sig_stats
    assert pcm.h2d_equiv_s(12345678) == rcm.h2d_equiv_s(12345678)


def test_cost_model_feedback_paths_equal_reference(profiles):
    rcm, pcm = models(profiles, True)
    for cm in (rcm, pcm):
        cm.observe_selectivity("L_SHIPDATE", 0.3)
        cm.observe_selectivity("L_SHIPDATE", 0.9)
        cm.observe_link(2, 1.7)
        cm.observe_link(0, 0.8)
        cm.observe_d2d(0.15)
        cm.observe_d2d(0.25)
        cm.observe_d2d(float("nan"))
    assert pcm.selectivity == rcm.selectivity
    assert pcm.selectivity_for("L_SHIPDATE") == rcm.selectivity_for("L_SHIPDATE")
    assert pcm.topology.to_json() == rcm.topology.to_json()
    assert pcm.topology.d2d_copy_s(1e-3) == rcm.topology.d2d_copy_s(1e-3)


def test_cost_model_save_load_round_trip(profiles, tmp_path):
    _, pcm = models(profiles, True)
    pcm.observe_selectivity("L_SHIPDATE", 0.4)
    pcm.observe_link(1, 1.3)
    pcm.observe_d2d(0.2)
    path = tmp_path / "cm.json"
    pcm.save(str(path))
    back = C.CostModel.load(str(path))
    assert back.spec.name == pcm.spec.name == "h100"
    for attr in ("alpha", "transfer_scale", "decode_scale", "n_observed", "sig_stats",
                 "selectivity"):
        assert getattr(back, attr) == getattr(pcm, attr), attr
    assert back.topology == pcm.topology
    assert back.profiles == {} and back.measured == {}
    topo = C.LinkTopology(n_links=3, link_scale=(1.0, 2.0), host_window=4,
                          d2d_scale=0.1, d2d_latency_s=1e-5)
    assert C.LinkTopology.from_json(topo.to_json()) == topo
    assert C.LinkTopology.from_json(None) == C.LinkTopology()


# ------------------------------------------------------------------ plans

def plan_fields(ep) -> tuple:
    return (ep.order, {n: dataclasses.asdict(d) for n, d in ep.decisions.items()},
            ep.window, ep.policy)


@pytest.mark.parametrize("observe", (False, True), ids=("seeded", "calibrated"))
@pytest.mark.parametrize("chunk_decode", (False, True))
@pytest.mark.parametrize("chunk_bytes", CHUNK_BYTES, ids=str)
@pytest.mark.parametrize("policy", POLICIES)
def test_plan_execution_equals_reference(policy, chunk_bytes, chunk_decode, observe,
                                         profiles):
    rcm, pcm = models(profiles, observe)
    kw = dict(policy=policy, chunk_bytes=chunk_bytes, chunk_decode=chunk_decode)
    want = RPL.plan_execution({n: r for n, (r, _) in profiles.items()}, rcm, **kw)
    got = PL.plan_execution({n: p for n, (_, p) in profiles.items()}, pcm, **kw)
    assert plan_fields(got) == plan_fields(want)
    assert got.modeled_makespan_s == pytest.approx(want.modeled_makespan_s, rel=REL)
    assert set(got.baselines) == set(want.baselines)
    for k, v in want.baselines.items():
        assert got.baselines[k] == pytest.approx(v, rel=REL), k
    assert got.explain() == want.explain()


def test_plan_batches_the_same_structure_pair(profiles):
    _, pcm = models(profiles, False)
    ep = PL.plan_execution({n: p for n, (_, p) in profiles.items()}, pcm,
                           policy="chunk-johnson", chunk_bytes=1 << 20)
    batched = {n for n, d in ep.decisions.items() if d.decode_mode == PL.BATCHED}
    assert {"L_DISCOUNT", "L_TAX"} <= batched
    order = list(ep.order)
    assert abs(order.index("L_DISCOUNT") - order.index("L_TAX")) == 1


# ------------------------------------------------------------------- runs

RUNS = {
    # the reference's defaults: chunk-johnson, 1 MiB transfer chunks, batching
    "default": (COLUMNS, dict(policy="chunk-johnson", chunk_bytes=1 << 20)),
    "adaptive-auto": (COLUMNS, dict(policy="adaptive", chunk_bytes="auto",
                                    chunk_decode=True)),
    "chunked-1KiB": (("L_DISCOUNT", "L_TAX", "L_RETURNFLAG", "PS_SUPPKEY", "O_ORDERKEY",
                      "L_SHIPDATE", "O_SHIPPRIORITY"),
                     dict(policy="chunk-johnson", chunk_bytes=1024, chunk_decode=True)),
    "fifo-whole": (("L_DISCOUNT", "L_TAX", "L_ORDERKEY", "O_COMMENT"),
                   dict(policy="fifo", chunk_bytes=None)),
}
REF_CACHE = RefCache()


@pytest.fixture(scope="module")
def runs(ref_encs):
    """Per configuration: both executors plan their columns with pinned cost
    models, then run their own (equal) plans."""
    mp = pytest.MonkeyPatch()
    mp.setattr(RC, "native_subtile", subtile)
    mp.setattr(C, "native_subtile", subtile)
    out = {}
    try:
        for label, (names, kw) in RUNS.items():
            rex = RefExecutor(cache=REF_CACHE, cost_model=pinned(RC), **kw)
            ex = StreamingExecutor("torch", "cpu", cost_model=pinned(C), **kw)
            for n in names:
                rex.compile(n, ref_encs[n])
                ex.compile(n, P.encoded_from_reference(ref_encs[n]))
            rplan, plan = rex.plan(), ex.plan()
            out[label] = {"rplan": rplan, "plan": plan, "ref": rex.run(plan=rplan),
                          "got": ex.run(plan=plan), "ex": ex, "names": names}
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("label", tuple(RUNS))
def test_run_plans_equal(label, runs):
    r = runs[label]
    assert plan_fields(r["plan"]) == plan_fields(r["rplan"])
    assert list(r["got"]) == [n for n in r["plan"].order if n in r["names"]]


@pytest.mark.parametrize("label,name", [(lb, n) for lb, (names, _) in RUNS.items()
                                        for n in names])
def test_plan_driven_run_matches_reference(label, name, runs, cols):
    r = runs[label]
    got, want = r["got"][name], r["ref"][name]
    a = got.array.numpy()
    np.testing.assert_array_equal(bits(a), bits(np.asarray(want.array)))
    np.testing.assert_array_equal(bits(a), bits(cols[name]))
    assert got.n_chunks == want.n_chunks
    assert got.decode_launches == want.decode_launches
    assert got.chunk_decoded == want.chunk_decoded
    assert got.batched_with == tuple(want.batched_with)
    assert got.kernel_launches == 0          # CPU: the plain versions


def test_runs_batch_the_pair_and_feed_the_cost_model(runs):
    r = runs["default"]
    assert r["got"]["L_DISCOUNT"].batched_with == ("L_TAX",)
    assert r["got"]["L_TAX"].batched_with == ("L_DISCOUNT",)
    ex = r["ex"]
    assert ex.timings is ex.cost_model.measured
    assert set(ex.timings) == set(r["names"]) and ex.cost_model.n_observed == len(r["names"])
    assert ex.program("L_DISCOUNT").batched_calls >= 1
    chunked = runs["chunked-1KiB"]["got"]
    assert chunked["L_RETURNFLAG"].chunk_decoded and chunked["L_SHIPDATE"].chunk_decoded
    assert not chunked["PS_SUPPKEY"].chunk_decoded


def test_run_refuses_uncovered_and_fused_plans(cols):
    """A plan that misses a registered column is refused.  A ``fused``
    decision is advisory, as in the reference: ``run`` decodes the column
    (only ``run_query`` fuses), so such a plan decodes every column."""
    names = ["L_SHIPDATE", "L_QUANTITY"]
    ex = StreamingExecutor("torch", "cpu")
    for n in names:
        ex.compile(n, P.encode(TABLE2_PLANS[n], cols[n]))
    partial = ex.plan(names[:1])
    with pytest.raises(ValueError, match="does not cover"):
        ex.run(plan=partial)
    plan = ex.plan()
    fused = dataclasses.replace(plan, decisions={
        **plan.decisions, names[0]: dataclasses.replace(plan.decisions[names[0]],
                                                        fused=True)})
    assert ex.issue_order() == list(plan.order)
    res = ex.run(plan=fused)
    for n in names:
        assert np.array_equal(res[n].array.numpy(), cols[n])


def test_pipeline_plan_and_run_on_the_cpu(cols):
    """``ColumnPipeline`` under the reference's defaults and under
    ``adaptive``/``"auto"``: plan, run the plan, re-plan from measurements."""
    pipe = ColumnPipeline(dict(TABLE2_PLANS), device="cpu")
    assert (pipe.executor.policy, pipe.executor.chunk_bytes, pipe.executor.batch_columns,
            pipe.executor.chunk_decode) == ("chunk-johnson", 1 << 20, True, False)
    pipe.compress(cols)
    for kw in ({}, dict(policy="adaptive", chunk_bytes="auto", chunk_decode=True)):
        plan = pipe.plan(**kw)
        res = pipe.run(plan=plan)
        assert list(res) == list(plan.order)
        for name in COLUMNS:
            np.testing.assert_array_equal(bits(res[name].array.numpy()), bits(cols[name]))
        assert pipe.makespan_s > 0
        replan = pipe.plan(**kw)
        assert set(replan.decisions) == set(COLUMNS) and replan.modeled_makespan_s > 0



KNOB_COLUMNS = ("L_DISCOUNT", "L_TAX", "L_RETURNFLAG", "L_SHIPDATE", "O_ORDERKEY")


@pytest.mark.parametrize("knobs", [dict(pipeline=False), dict(prefetch_chunks=3),
                                   dict(pipeline=False, prefetch_chunks=0)],
                         ids=("no-pipeline", "prefetch-3", "no-pipeline-prefetch-0"))
def test_pipeline_and_prefetch_knobs_as_the_reference(knobs, ref_encs, cols):
    """The constructor's ``pipeline`` (False: the default policy becomes FIFO,
    an explicit one still wins) and ``prefetch_chunks`` (the plan's window, at
    least 1) give the reference's plans and issue order, and the runs of those
    plans equal the reference's."""
    kw = dict(chunk_bytes=1024, chunk_decode=True, **knobs)
    rex = RefExecutor(cache=REF_CACHE, cost_model=pinned(RC), **kw)
    ex = StreamingExecutor("torch", "cpu", cost_model=pinned(C), **kw)
    for n in KNOB_COLUMNS:
        rex.compile(n, ref_encs[n])
        ex.compile(n, P.encoded_from_reference(ref_encs[n]))
    rplan, plan = rex.plan(), ex.plan()
    assert plan_fields(plan) == plan_fields(rplan)
    assert plan.policy == ("fifo" if knobs.get("pipeline") is False else "chunk-johnson")
    if "prefetch_chunks" in knobs:
        assert plan.window == max(1, knobs["prefetch_chunks"])
    assert ex.issue_order() == rex.issue_order()
    assert plan_fields(ex.plan(policy="johnson")) == plan_fields(rex.plan(policy="johnson"))
    got, want = ex.run(plan=plan), rex.run(plan=rplan)
    assert list(got) == list(want)
    for n in KNOB_COLUMNS:
        np.testing.assert_array_equal(bits(got[n].array.numpy()), bits(cols[n]))
        assert (got[n].n_chunks, got[n].decode_launches, got[n].batched_with) == \
            (want[n].n_chunks, want[n].decode_launches, tuple(want[n].batched_with))


def test_pipeline_passes_pipeline_false_through():
    pipe = ColumnPipeline(dict(TABLE2_PLANS), device="cpu", pipeline=False)
    assert pipe.executor.pipeline is False
    pipe.load({"L_TAX": P.encode(TABLE2_PLANS["L_TAX"], np.arange(300, dtype=np.float32) / 100)})
    assert pipe.plan().policy == "fifo"


# ------------------------------------------------------------ batched decode

def rle_pair():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 50, 500)
    counts = rng.integers(1, 120, 500)
    return (np.repeat(vals, counts).astype(np.int32),
            np.repeat(vals, counts[::-1]).astype(np.int32))


def ans_pair(chunk: int = 512):
    """Two rANS columns of one shape and tables whose data differ: the second
    is the first with its chunks in another order."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 40, 40 * chunk).astype(np.uint8)
    b = a.reshape(40, chunk)[rng.permutation(40)].reshape(-1)
    return a, b


def batched_cases(cols):
    plan_ans = P.Plan("ans", params={"chunk_size": 512})
    return {
        "fp-pair": [P.encode(TABLE2_PLANS[k], cols[k]) for k in ("L_DISCOUNT", "L_TAX")],
        "gp-rle": [P.encode(P.make_plan("rle"), a) for a in rle_pair()],
        "np-ans": [P.encode(plan_ans, a) for a in ans_pair()],
    }


@pytest.mark.parametrize("k", (1, 2, 3, 12))
@pytest.mark.parametrize("case", ("fp-pair", "gp-rle", "np-ans"))
def test_program_batched_equals_single_calls(case, k, cols):
    encs = batched_cases(cols)[case]
    cache = ProgramCache()
    progs = [cache.get(build_graph(e), backend="torch") for e in encs]
    assert progs[0] is progs[1]              # one structure, different data
    members = [device_buffers(encs[i % len(encs)], "cpu") for i in range(k)]
    out = progs[0].batched(members)
    assert out.shape == (k, encs[0].n) and progs[0].batched_calls == 1
    for i, m in enumerate(members):
        single = progs[0](m)
        np.testing.assert_array_equal(bits(out[i].numpy()), bits(single.numpy()))
        np.testing.assert_array_equal(bits(out[i].numpy()), bits(P.decode_np(encs[i % 2])))
    kernel = cache.get(build_graph(encs[0]), backend="kernel")
    assert torch.equal(kernel.batched(members), out)   # CPU tensors: the plain versions


@pytest.mark.parametrize("case", ("fp-pair", "gp-rle", "np-ans"))
def test_batched_stage_plain_versions_write_outs(case, cols):
    """``run_stage_batched`` writes each member's result into its ``outs`` on
    both backends (the kernel wrappers take the plain versions for CPU
    tensors), and every stage's batched plain version equals its single one."""
    encs = batched_cases(cols)[case]
    graph = build_graph(encs[0])
    envs = [device_buffers(e, "cpu") for e in encs]
    for st in graph.stages:
        singles = [ref_stage(st, env) for env in envs]
        for backend in ("torch", "kernel"):
            outs = [torch.empty_like(s) for s in singles]
            got = run_stage_batched(st, envs, backend, outs=outs)
            for g, o, s in zip(got, outs, singles):
                assert g.data_ptr() == o.data_ptr()
                np.testing.assert_array_equal(bits(o.numpy()), bits(s.numpy()))
        for env, s in zip(envs, singles):
            env[st.out] = s


def ref_stage(st, env):
    from repro_torch.kernels.ops import run_stage

    return run_stage(st, env, "torch")


def test_np_batched_plain_version_equals_single_decodes():
    encs = [P.encode(P.Plan("ans", params={"chunk_size": 512}), a) for a in ans_pair()]
    (st,) = build_graph(encs[0]).stages
    envs = [device_buffers(e, "cpu") for e in encs]
    got = ref.non_parallel_batched_torch(st, envs)
    for g, env, e in zip(got, envs, encs):
        assert torch.equal(g, ref.non_parallel_torch(st, env))
        np.testing.assert_array_equal(g.numpy(), P.decode_np(e))


def test_executor_batches_same_structure_columns(cols):
    """Two RLE columns of one structure whose runs differ, marked batched by the
    plan, decode in one unit: both equal their sources, each names the other."""
    a, b = rle_pair()
    ex = StreamingExecutor("torch", "cpu", policy="fifo")
    ex.compile("a", P.encode(P.make_plan("rle"), a))
    ex.compile("b", P.encode(P.make_plan("rle"), b))
    plan = ex.plan()
    assert {d.decode_mode for d in plan.decisions.values()} == {PL.BATCHED}
    res = ex.run(plan=plan)
    np.testing.assert_array_equal(res["a"].array.numpy(), a)
    np.testing.assert_array_equal(res["b"].array.numpy(), b)
    assert res["a"].batched_with == ("b",) and res["b"].batched_with == ("a",)
    assert ex.program("a").batched_calls == 1 and ex.program("a").calls == 0
    # batching off: two single decodes
    off = StreamingExecutor("torch", "cpu", policy="fifo", batch_columns=False)
    off.compile("a", P.encode(P.make_plan("rle"), a))
    off.compile("b", P.encode(P.make_plan("rle"), b))
    res = off.run()
    assert res["a"].batched_with == () and off.program("a").calls == 2


def test_launch_batched_splits_at_the_library_limit(monkeypatch):
    """A batch of 25 kernel-1 structs is three launches of at most 11, each
    counted once, in order; a launch the library refuses raises."""
    calls, status = [], [0]

    def entry(ptr, k, threads, device, stream):
        calls.append(k)
        return status[0]

    lib = cuda.KernelLib("fully_parallel", "zf_fully_parallel", cuda.ZfFpArgs)
    lib.batch_max = 11                       # what the library reports at load
    lib._lib = type("Lib", (), {"zf_error_string": staticmethod(lambda err: b"bad")})()
    lib.preload_s[0] = 0.0                   # its kernels count as loaded on cuda:0
    lib._batched = entry
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    members = [cuda.ZfFpArgs(n=i + 1) for i in range(25)]
    lib.launch_batched(members, 256, torch.device("cuda", 0))
    assert calls == [11, 11, 3] and lib.launches == lib.batched_launches == 3
    assert lib.largest_batch == 25           # the batch as given, before its split
    status[0] = 1
    with pytest.raises(RuntimeError, match="batched launch"):
        lib.launch_batched(members[:2], 256, torch.device("cuda", 0))
    assert lib.launches == 3


def test_load_reads_the_limit_and_loads_every_kernel_once_per_device(monkeypatch):
    """``KernelLib.load`` takes the batch limit from the library and, given a
    CUDA device, loads its kernels there once (``zf_preload``); a failure
    raises.  A library without the batched entry (an older tree's) loads as
    before and refuses a batched launch."""
    calls, status = [], [0]

    class Fn:
        def __init__(self, body):
            self.body = body

        def __call__(self, *a):
            return self.body(*a)

    class Lib:
        zf_args_size = Fn(lambda: ctypes.sizeof(cuda.ZfFpArgs))
        zf_batch_max = Fn(lambda: 11)
        zf_preload = Fn(lambda dev: calls.append(dev) or status[0])
        zf_error_string = Fn(lambda err: b"bad")
        zf_fully_parallel = Fn(lambda *a: 0)

    class Old(Lib):
        zf_batch_max = zf_preload = None

        def __getattribute__(self, name):
            if name in ("zf_batch_max", "zf_preload"):
                raise AttributeError(name)
            return object.__getattribute__(self, name)

    monkeypatch.setattr(cuda, "build", lambda libs: None)
    monkeypatch.setattr(cuda.ctypes, "CDLL", lambda path: Lib())
    lib = cuda.KernelLib("fully_parallel", "zf_fully_parallel", cuda.ZfFpArgs)
    lib.load()
    assert lib.batch_max == 11 and calls == [] and lib.preload_s == {}
    lib.load(torch.device("cuda", 1))
    lib.load(torch.device("cuda", 1))
    lib.load(torch.device("cpu"))
    assert calls == [1] and set(lib.preload_s) == {1}
    status[0] = 2
    with pytest.raises(RuntimeError, match="loading its kernels failed"):
        lib.load(torch.device("cuda", 0))
    monkeypatch.setattr(cuda.ctypes, "CDLL", lambda path: Old())
    old = cuda.KernelLib("fully_parallel", "zf_fully_parallel", cuda.ZfFpArgs)
    old.load(torch.device("cuda", 0))
    assert old.batch_max is None and old.preload_s == {}
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    with pytest.raises(RuntimeError, match="no batched entry"):
        old.launch_batched([cuda.ZfFpArgs(n=1)], 256, torch.device("cuda", 0))
