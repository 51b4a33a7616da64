"""The port's mesh decode planner against the JAX reference's, on the CPU.

  * From the same ``Encoded`` blobs each package builds its own profiles, and
    ``plan_mesh_execution`` runs with both cost models pinned to one chip
    spec, at N in {1, 2, 4, 8}, with and without ``shard_threshold_bytes=0``,
    on the fabric topologies of ``tests/test_mesh_decode.py`` and with
    ``placement="sharded"``: ``assignment``, ``shards``, ``placement``,
    ``redistribution``, ``policy``, ``window`` and each device's order and
    decisions are equal; the makespans and baselines agree within 1e-12
    relative (they are expected to be bit-identical).
  * ``replan_suffix`` gives the reference's plan after a device loss, and
    ``ColumnPipeline(mesh=4).mesh_plan()`` the reference pipeline's; its
    ``run_sharded()`` decodes bitwise the reference pipeline's.
  * The reference's own dominance and coverage tests
    (``test_mesh_decode.py``) run on the port's planner.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import costmodel as RC
from repro.core import plan as RP
from repro.core import planner as RPL
from repro.core import scheduler as RS
from repro.core.compiler import build_graph as ref_build_graph
from repro.data.columns import TABLE2_PLANS as REF_PLANS
from repro.data.loader import ColumnPipeline as RefPipeline
from repro.launch.elastic import replan_suffix as ref_replan_suffix

from repro_torch.core import costmodel as C
from repro_torch.core import plan as P
from repro_torch.core import planner as PL
from repro_torch.core import scheduler as S
from repro_torch.core.compiler import build_graph
from repro_torch.core.costmodel import ColumnProfile, CostModel, LinkTopology
from repro_torch.core.executor import MeshRunResult
from repro_torch.core.planner import (SHARD_SEP, plan_execution, plan_mesh_execution,
                                      shard_column_of, shard_name)
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.loader import ColumnPipeline
from repro_torch.data.tpch import generate
from repro_torch.launch.elastic import replan_suffix

# the port's seeded H100 entries, given to both chip specs
PIN = dict(hbm_gbps=3350.0, host_link_gbps=48.8, grid_step_overhead_ns=254_000.0)
REL = 1e-12
# a few columns of each kind keep the exchange search (quadratic in items)
# short; L_RETURNFLAG is the group-chunkable one (30 groups at SCALE, so it
# splits into shards at every N here)
COLUMNS = ("L_ORDERKEY", "L_QUANTITY", "L_DISCOUNT", "L_TAX", "L_SHIPDATE", "L_EXTENDEDPRICE",
           "O_ORDERKEY", "O_TOTALPRICE", "PS_PARTKEY", "O_COMMENT", "L_RETURNFLAG")
SCALE = 0.02


def subtile(pattern: str, chip: str = "", itemsize: int = 4) -> int:
    """One chunk-ladder tile for both packages (their chips' geometries differ)."""
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
def cols():
    data = generate(SCALE, seed=0)
    return {k: data[k] for k in COLUMNS}


@pytest.fixture(scope="module")
def profiles(cols):
    """name -> (reference profile, port profile), each from its own graph."""
    out = {}
    for name in COLUMNS:
        renc = RP.encode(REF_PLANS[name], cols[name])
        penc = P.encoded_from_reference(renc)
        out[name] = (RC.profile_from(name, renc, ref_build_graph(renc)),
                     C.profile_from(name, penc, build_graph(penc)))
    return out


def models(profiles, observe: bool = True):
    rcm, pcm = pinned(RC), pinned(C)
    for rp, pp in profiles.values():
        rcm.register(rp)
        pcm.register(pp)
    if observe:
        rng = np.random.default_rng(0)
        for name in list(profiles)[::2]:
            t, d = float(rng.uniform(1e-5, 2e-3)), float(rng.uniform(1e-5, 5e-3))
            rcm.observe(name, t, d)
            pcm.observe(name, t, d)
    return rcm, pcm


def mesh_fields(mp) -> tuple:
    plans = tuple((pl.order, {n: dataclasses.asdict(d) for n, d in pl.decisions.items()},
                   pl.window, pl.policy) for pl in mp.plans)
    shards = {c: tuple(dataclasses.astuple(s) for s in ss) for c, ss in mp.shards.items()}
    return (mp.n_devices, mp.device_ids, dict(mp.assignment), shards, dict(mp.placement),
            mp.redistribution, mp.policy, mp.window, mp.placement_policy, plans)


def assert_same_plan(got, want):
    assert mesh_fields(got) == mesh_fields(want)
    assert got.modeled_makespan_s == pytest.approx(want.modeled_makespan_s, rel=REL)
    assert set(got.baselines) == set(want.baselines)
    for k, v in want.baselines.items():
        assert got.baselines[k] == pytest.approx(v, rel=REL), k
    for a, b in zip(got.plans, want.plans):
        assert a.modeled_makespan_s == pytest.approx(b.modeled_makespan_s, rel=REL)
    assert got.explain().replace("cuda device", "jax device") == want.explain()


def both(profiles, rcm, pcm, **kw):
    want = RPL.plan_mesh_execution({n: r for n, (r, _) in profiles.items()}, rcm, **kw)
    got = plan_mesh_execution({n: p for n, (_, p) in profiles.items()}, pcm, **kw)
    return got, want


# ------------------------------------------------------------ parity

@pytest.mark.parametrize("threshold", (None, 0), ids=("fair-share", "shard-all"))
@pytest.mark.parametrize("n_devices", (1, 2, 4, 8))
def test_mesh_plan_equals_reference(n_devices, threshold, profiles):
    rcm, pcm = models(profiles)
    got, want = both(profiles, rcm, pcm, n_devices=n_devices,
                     shard_threshold_bytes=threshold)
    assert_same_plan(got, want)
    if n_devices > 1 and threshold == 0:      # L_RETURNFLAG splits into shards
        assert list(got.shards) == ["L_RETURNFLAG"]


def _ref_topology(topo: LinkTopology) -> RC.LinkTopology:
    return RC.LinkTopology(**dataclasses.asdict(topo))


@pytest.mark.parametrize("case", ("skew-fabric", "slow-link-fabric", "no-fabric"))
def test_sharded_placement_on_fabric_topologies_equals_reference(case, profiles):
    """The fabric topologies of the reference's redistribution tests, with
    ``placement="sharded"``: the same D2D legs and final placement."""
    rcm, pcm = models(profiles)
    N = 2 if case == "skew-fabric" else 4
    scale = (4.0, 1.0) if case == "skew-fabric" else (6.0, 1.0, 1.0, 1.0)
    d2d = {"skew-fabric": 0.1, "slow-link-fabric": 0.05, "no-fabric": None}[case]
    topo = LinkTopology(n_links=N, link_scale=scale, d2d_scale=d2d)
    kw = dict(n_devices=N, shard_threshold_bytes=0, placement="sharded")
    want = RPL.plan_mesh_execution({n: r for n, (r, _) in profiles.items()}, rcm,
                                   topology=_ref_topology(topo), **kw)
    got = plan_mesh_execution({n: p for n, (_, p) in profiles.items()}, pcm,
                              topology=topo, **kw)
    assert_same_plan(got, want)
    assert got.placement_policy == "sharded"
    assert bool(got.redistribution) == (d2d is not None)     # the fabric's D2D legs
    for specs in got.shards.values():
        for s in specs:
            assert got.final_device(s.name) == s.index % N


def test_replan_suffix_equals_reference(profiles):
    rcm, pcm = models(profiles)
    got, want = both(profiles, rcm, pcm, n_devices=4, shard_threshold_bytes=0)
    done = list(want.columns())[:3]
    rprof = {n: r for n, (r, _) in profiles.items()}
    pprof = {n: p for n, (_, p) in profiles.items()}
    want2 = ref_replan_suffix(want, done, (0, 2, 3), rcm, rprof)
    got2 = replan_suffix(got, done, (0, 2, 3), pcm, pprof)
    assert_same_plan(got2, want2)
    assert got2.device_ids == (0, 2, 3) and got2.topology.n_links == 3
    assert replan_suffix(got, list(profiles), (0, 1), pcm, pprof) is None
    with pytest.raises(RuntimeError, match="zero devices"):
        replan_suffix(got, done, (), pcm, pprof)


def test_pipeline_mesh_plan_equals_reference(cols):
    plans = {c: REF_PLANS[c] for c in COLUMNS}
    rpipe = RefPipeline(plans, cost_model=pinned(RC), mesh=4)
    rpipe.compress(cols)
    pipe = ColumnPipeline({c: TABLE2_PLANS[c] for c in COLUMNS}, device="cpu",
                          cost_model=pinned(C), mesh=4)
    pipe.load({c: P.encoded_from_reference(rpipe._encoded[c]) for c in COLUMNS})
    assert_same_plan(pipe.mesh_plan(), rpipe.mesh_plan())
    assert pipe.mesh_plan(n_devices=2).n_devices == 2
    cpu = ColumnPipeline({c: TABLE2_PLANS[c] for c in COLUMNS[:2]}, device="cpu")
    cpu.load({c: P.encoded_from_reference(rpipe._encoded[c]) for c in COLUMNS[:2]})
    assert cpu.mesh_plan().n_devices == 1     # a CPU pipeline plans one device
    # run on the one host device each package sees, every logical id mapped onto it
    want, got = rpipe.run_sharded(), pipe.run_sharded()
    assert isinstance(got, MeshRunResult)
    assert set(got.columns) == set(want.columns) == set(COLUMNS)
    assert got.per_device == want.per_device
    for c in COLUMNS:
        np.testing.assert_array_equal(got[c].array.numpy(), np.asarray(want[c].array))
        np.testing.assert_array_equal(got[c].array.numpy(), cols[c])


def test_one_device_mesh_plan_equals_plan_execution(profiles):
    _, pcm = models(profiles)
    pprof = {n: p for n, (_, p) in profiles.items()}
    mp = plan_mesh_execution(pprof, pcm, n_devices=1)
    base = plan_execution(pprof, pcm, policy="adaptive", chunk_bytes="auto",
                          chunk_decode=True, batch_columns=False)
    assert mp.modeled_makespan_s == pytest.approx(base.modeled_makespan_s, rel=REL)


def _at_window(plan, cm, planner, scheduler) -> float:
    """``plan``'s single-device pipeline simulated at its own staging window."""
    names = list(plan.order)
    return scheduler.simulate_stream(
        [scheduler.Job(n, plan.decisions[n].est_transfer_s, plan.decisions[n].est_decode_s)
         for n in names],
        [planner._chunk_info(plan.decisions[n], cm.launch_overhead_s(n)) for n in names],
        window=plan.window)


@pytest.mark.parametrize("seed", (0, 5), ids=("window-free", "window-binds"))
def test_one_device_mesh_plan_is_plan_execution_at_its_window(seed, profiles):
    """At N = 1 the mesh planner simulates ``plan_execution``'s plan at the
    plan's staging window.  ``plan_execution`` reports the UNBOUNDED makespan
    and picks the window after (8 when no window up to 8 is stall-free), so
    the two makespans differ exactly when the window binds, in the reference
    as in the port.  With these observed timings and 32 KiB chunks, seed 5
    is such a case and seed 0 is not.  Exact: 1e-12 relative."""
    rcm, pcm = models(profiles, observe=False)
    rng = np.random.default_rng(seed)
    for name, (_, p) in profiles.items():
        t = p.compressed_nbytes / 40e9 * rng.uniform(0.5, 2)
        d = p.plain_nbytes / 1000e9 * rng.uniform(0.2, 20)
        rcm.observe(name, t, d)
        pcm.observe(name, t, d)
    kw = dict(policy="chunk-johnson", chunk_bytes=1 << 15)
    got, want = both(profiles, rcm, pcm, n_devices=1, **kw)
    assert_same_plan(got, want)
    pprof = {n: p for n, (_, p) in profiles.items()}
    rprof = {n: r for n, (r, _) in profiles.items()}
    one = plan_execution(pprof, pcm, chunk_decode=True, batch_columns=False, **kw)
    rone = RPL.plan_execution(rprof, rcm, chunk_decode=True, batch_columns=False, **kw)
    mk = got.modeled_makespan_s
    assert mk == pytest.approx(_at_window(one, pcm, PL, S), rel=REL)
    assert want.modeled_makespan_s == pytest.approx(_at_window(rone, rcm, RPL, RS), rel=REL)
    assert one.modeled_makespan_s == pytest.approx(rone.modeled_makespan_s, rel=REL)
    assert one.modeled_makespan_s <= mk * (1 + REL)
    binds = mk > one.modeled_makespan_s * (1 + 1e-9)
    assert binds == (seed == 5) and (one.window == 8 or not binds)


# ---------------------------------------------- the reference's own contracts

def _profiles(n=7, seed=0, groups=64):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        nb = int(rng.integers(1 << 16, 1 << 21))
        presum = np.linspace(0, nb // 4, groups + 1).astype(np.int64)
        out[f"c{i}"] = ColumnProfile(
            name=f"c{i}", compressed_nbytes=nb, plain_nbytes=nb * 3,
            n_kernels=2, signature=f"s{i % 3}", group_chunkable=True,
            n_groups=groups, group_bytes=float(nb) / groups, group_align=1,
            pattern="np", group_out_presum=presum)
    return out


def _model(profiles) -> CostModel:
    cm = CostModel()
    for p in profiles.values():
        cm.register(p)
    return cm


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mesh_assignment_dominance(n_devices, seed):
    """Chosen modeled makespan <= round-robin AND single-device baselines on
    every (seed, N) -- they are always among the scored candidates."""
    profiles = _profiles(seed=seed)
    mp = plan_mesh_execution(profiles, _model(profiles), n_devices=n_devices)
    mk = mp.modeled_makespan_s
    assert mk <= mp.baselines["round-robin"] + 1e-12
    assert mk <= mp.baselines["single-device"] + 1e-12
    assert mk == pytest.approx(min(mp.baselines.values()), abs=1e-12)
    assert sorted(mp.assignment[i] for i in mp.items) == sorted(mp.assignment.values())
    for col, specs in mp.shards.items():
        assert [s.index for s in specs] == list(range(len(specs)))
        assert specs[0].g_lo == 0
        assert specs[-1].g_hi == profiles[col].n_groups
        for a, b in zip(specs, specs[1:]):
            assert a.g_hi == b.g_lo and a.out_hi == b.out_lo


def test_mesh_plan_covers_all_columns():
    profiles = _profiles()
    mp = plan_mesh_execution(profiles, _model(profiles), n_devices=4,
                             shard_threshold_bytes=0)
    assert set(mp.columns()) == set(profiles)
    assert mp.shards
    per_plan = [it for plan in mp.plans for it in plan.order]
    assert sorted(per_plan) == sorted(mp.items)
    assert shard_column_of(shard_name("x", 3)) == "x"
    assert shard_column_of("plain") == "plain"
    assert SHARD_SEP in shard_name("x", 0)


def test_single_device_mesh_matches_base_planner():
    profiles = _profiles(n=4)
    mp = plan_mesh_execution(profiles, _model(profiles), n_devices=1)
    assert mp.n_devices == 1 and len(mp.plans) == 1
    assert not mp.shards
    assert sorted(mp.plans[0].order) == sorted(profiles)
