"""The port's launch-geometry layer against the JAX reference's, on the CPU.

  * the searchers: ``autotune.brute_force`` and ``pruned_search`` given the
    reference's v5e spaces (as the port's ``SPACES``) and its
    ``analytic_measure`` return the reference's ``TuneResult``: best, cost,
    probes and history;
  * on the port's own H100 spaces and ``analytic_cost_ns``, the pruned search
    lands within 1.001x of brute force with fewer probes, at most 25, for
    fp/gp/np at every output width;
  * the spaces hold only what the kernels take: powers of two, whole warps,
    a block's registers and shared memory within the card's, kernel 2 at
    least a warp; the native table's geometries lie in them; the model is
    finite on every geometry and charges the shared-memory cliff;
  * every geometry of every space passes the wrappers' host-side argument
    packing (``_launch_args``; kernel 1's ``stage_words`` within its cap) for
    one stage per pattern of the Table-2 columns;
  * the native table and the planner's chunk ladder are unchanged.
"""
import pytest
import torch

from repro.core import autotune as RA
from repro.core import geometry as RG

from repro_torch.core import autotune as A
from repro_torch.core import geometry as G
from repro_torch.core import plan as P
from repro_torch.core.compiler import build_graph, device_buffers
from repro_torch.core.patterns import Aux, FullyParallel, GroupParallel, NonParallel
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.tpch import generate
from repro_torch.kernels import fully_parallel as FPK
from repro_torch.kernels import group_parallel as GPK
from repro_torch.kernels import non_parallel as NPK
from repro_torch.kernels.ops import run_stage

PATTERNS = ("fp", "gp", "np")
WIDTHS = (1, 2, 4)
H100 = G.chip("h100")
CPU = torch.device("cpu")


def as_ref(g: G.Geometry) -> RG.Geometry:
    return RG.Geometry(g.L, g.S, g.C)


def ref_spaces():
    """The reference's spaces, yielding the port's Geometry."""
    return {p: (lambda spec, itemsize=4, f=f: (G.Geometry(g.L, g.S, g.C)
                                                 for g in f(spec, itemsize)))
            for p, f in RG.SPACES.items()}


def flat(res):
    return ((res.best.L, res.best.S, res.best.C), res.cost, res.probes,
            [((g.L, g.S, g.C), c) for g, c in res.history])


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_searchers_equal_the_references_on_its_spaces(pattern, itemsize, monkeypatch):
    spec = RG.chip("v5e")
    monkeypatch.setattr(A, "SPACES", ref_spaces())
    measure = RA.analytic_measure(pattern, spec, itemsize=itemsize)
    port = lambda g: measure(as_ref(g))   # noqa: E731
    assert flat(A.brute_force(pattern, spec, port, itemsize)) == \
        flat(RA.brute_force(pattern, spec, measure, itemsize))
    assert flat(A.pruned_search(pattern, spec, port, itemsize)) == \
        flat(RA.pruned_search(pattern, spec, measure, itemsize))


@pytest.mark.parametrize("itemsize", WIDTHS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_pruned_search_finds_the_brute_force_best_on_the_h100_model(pattern, itemsize):
    measure = A.analytic_measure(pattern, H100, itemsize=itemsize)
    brute = A.brute_force(pattern, H100, measure, itemsize)
    pruned = A.pruned_search(pattern, H100, measure, itemsize)
    assert brute.probes == len(list(G.SPACES[pattern](H100, itemsize)))
    assert pruned.cost <= brute.cost * 1.001
    assert pruned.probes < brute.probes and pruned.probes <= 25
    assert [c for _, c in pruned.history] == sorted(c for _, c in pruned.history)
    assert pruned.history[0] == (pruned.best, pruned.cost)


@pytest.mark.parametrize("itemsize", WIDTHS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_spaces_hold_only_what_the_kernels_take(pattern, itemsize):
    space = list(G.SPACES[pattern](H100, itemsize))
    assert len(space) == len(set(space)) > 40
    for g in space:
        for v in (g.L, g.S, g.C):
            assert v & (v - 1) == 0
        assert g.S % 32 == 0 and g.S <= H100.max_threads_per_block
        assert g.S * G.KERNEL_REGS[pattern] <= H100.regs_per_sm
        assert G.smem_bytes(pattern, g, itemsize) <= H100.smem_per_block
        assert G.blocks_per_sm(pattern, g, H100, itemsize) >= 1
        cost = G.analytic_cost_ns(pattern, g, 1 << 24, itemsize, H100)
        assert 0 < cost < float("inf")
    assert G.native_config(pattern, out_width=itemsize) in space
    # kernels 2 and 3 take at most 512 threads a block: their registers
    top = max(g.S for g in space)
    assert top == (1024 if pattern == "fp" else 512)


@pytest.mark.parametrize("pattern", ["fp", "gp"])
def test_the_model_charges_the_shared_memory_cliff(pattern, monkeypatch):
    """A window past the kernel's shared buffer is valid but slow, as the
    reference's VMEM cliff: kernel 1 at 16 x 1024 x 16 4-byte outputs stages
    256 K words, kernel 2 at 512 x 16 a sub-tile needs 8 K groups; the
    footprint itself stays at the kernel's cap."""
    big, fits = (G.Geometry(16, 1024, 16), G.Geometry(16, 256, 4)) if pattern == "fp" \
        else (G.Geometry(1, 512, 16), G.Geometry(1, 512, 4))
    assert G._spills(pattern, big, 4) and not G._spills(pattern, fits, 4)
    assert G.smem_bytes(pattern, big, 4) == (G.FP_MAX_SMEM if pattern == "fp"
                                             else G.GP_MAX_SMEM)
    n = 1 << 26
    cost = {g: G.analytic_cost_ns(pattern, g, n, 4, H100) for g in (big, fits)}
    monkeypatch.setattr(G, "CLIFF", 1.0)
    assert cost[big] > G.analytic_cost_ns(pattern, big, n, 4, H100)
    assert cost[fits] == G.analytic_cost_ns(pattern, fits, n, 4, H100)


def test_native_table_and_chunk_ladder_are_unchanged():
    """The tuner's findings are recorded, not applied: the measured table and
    the planner's sub-tiles stay as PRs 14-15 set them."""
    assert G._NATIVE == {"h100": {"fp": G.Geometry(4, 256, 4), "gp": G.Geometry(4, 256, 4),
                                  "np": G.Geometry(1, 64, 1)}}
    assert [G.native_subtile(p) for p in ("fp", "gp", "np", "aux")] == [1024, 1024, 64, 1024]
    assert G.native_config("fp", out_width=1) == G.Geometry(1, 256, 16)
    assert G.native_config("gp", out_width=2) == G.Geometry(4, 256, 8)


@pytest.fixture(scope="module")
def stages():
    """One stage per pattern from the Table-2 columns at scale 0.002, with
    what each reads (CPU tensors): pattern -> [(stage, env)]."""
    cols = generate(0.002, seed=0)
    out = {p: [] for p in PATTERNS}
    for name in ("L_EXTENDEDPRICE", "O_COMMENT", "L_ORDERKEY", "L_RETURNFLAG"):
        enc = P.encode(TABLE2_PLANS[name], cols[name])
        env = device_buffers(enc, "cpu")
        for st in build_graph(enc).stages:
            sts = st.producers + (st,) if isinstance(st, Aux) else (st,)
            for s in sts:
                kind = {FullyParallel: "fp", GroupParallel: "gp",
                        NonParallel: "np"}.get(type(s))
                if kind:
                    out[kind].append((s, dict(env)))
            env[st.out] = run_stage(st, env, "torch")
    return {p: v[:2] for p, v in out.items()}


@pytest.mark.parametrize("pattern", PATTERNS)
def test_every_geometry_packs_its_launch(pattern, stages):
    for st, env in stages[pattern]:
        for itemsize in WIDTHS:
            for g in G.SPACES[pattern](H100, itemsize):
                if pattern == "fp":
                    args, dst, geom = FPK._launch_args(st, env, CPU, g, st.n_out, None)
                    assert FPK.stage_words(g) * 4 <= FPK.MAX_STAGE_BYTES
                    assert args.stage_words == FPK.stage_words(g)
                elif pattern == "gp":
                    args, dst, geom = GPK._launch_args(st, env, CPU, g, None, 0, 0,
                                                       st.n_out, None)
                else:
                    args, dst, geom = NPK._launch_args(st, env, CPU, g, st.n_chunks,
                                                       st.n_out, None)
                assert geom == g and (args.L, args.C) == (g.L, g.C)
                assert dst.numel() == st.n_out

