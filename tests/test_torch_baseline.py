"""The unfused ``baseline`` backend and the reference's compile and model API in
the port, against the JAX reference on the CPU (TPC-H at scale 0.002, seed 0).

  * for all 24 Table-2 columns, ``compile_decoder(enc, backend="baseline")``
    gives the reference's ``compile_decoder(enc, backend="baseline")`` output
    bitwise (the reference's jnp stages on the CPU), with equal stage names,
    ``n_kernels`` and unfused signatures; ``build_graph(fuse=False)`` run by
    the plain backend does too;
  * the baseline launches every stage at ``BASELINE_GEOMS``, a caller's
    ``geometry`` reaches the kernels' wrappers, and ``ProgramCache`` keys
    programs by signature, backend and geometry;
  * ``ColumnPipeline.modeled_makespan`` equals the reference's for every
    (pipeline, johnson, chunked) with both cost models pinned and the same
    times, measures each column once, and ``ColumnPipeline(executor=ex)``
    uses ``ex``; ``fuse=False`` decodes bitwise as the fused pipeline does.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import compiler as RC
from repro.core import costmodel as RCM
from repro.core import plan as RP
from repro.core.executor import StreamingExecutor as RefExecutor
from repro.data.columns import TABLE2_PLANS as REF_PLANS
from repro.data.loader import ColumnPipeline as RefPipeline

from repro_torch.core import costmodel as CM
from repro_torch.core import plan as P
from repro_torch.core.compiler import (BASELINE_GEOMS, ProgramCache, build_graph,
                                       compile_blob, compile_decoder, decode_on_device,
                                       device_buffers)
from repro_torch.core.executor import StreamingExecutor
from repro_torch.core.geometry import Geometry
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.loader import ColumnPipeline
from repro_torch.data.tpch import generate
from repro_torch.kernels import ops

COLUMNS = tuple(TABLE2_PLANS)
PIN = dict(hbm_gbps=3350.0, host_link_gbps=48.8, grid_step_overhead_ns=254_000.0)


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.fixture(scope="module")
def cols():
    return {k: v for k, v in generate(0.002, seed=0).items() if k in TABLE2_PLANS}


@pytest.fixture(scope="module")
def encs(cols):
    """name -> (reference blob, the port's blob of the same bytes)."""
    out = {}
    for name in COLUMNS:
        renc = RP.encode(REF_PLANS[name], cols[name])
        out[name] = (renc, P.encoded_from_reference(renc))
    return out


@pytest.mark.parametrize("name", COLUMNS)
def test_baseline_decoder_equals_the_references(name, cols, encs):
    renc, enc = encs[name]
    rdec = RC.compile_decoder(renc, backend="baseline")
    want = np.asarray(rdec(RC.device_buffers(renc)))
    dec = compile_decoder(enc, backend="baseline")
    got = dec(device_buffers(enc, "cpu")).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(got), bits(cols[name]))
    assert [st.name for st in dec.stages] == [st.name for st in rdec.stages]
    assert dec.n_kernels == rdec.n_kernels == len(dec.stages)
    assert dec.backend == "baseline" and dec.program.geometry == BASELINE_GEOMS
    unfused = build_graph(enc, fuse=False)
    assert unfused.signature == RC.build_graph(renc, fuse=False).signature
    assert dec.program.graph.signature == unfused.signature
    plain = compile_decoder(enc, backend="torch", fuse=False)(device_buffers(enc, "cpu"))
    np.testing.assert_array_equal(bits(plain.numpy()), bits(want))


def test_baseline_is_unfused_and_the_fused_graph_is_not(encs):
    """The baseline forces ``fuse=False`` (``compile_blob``); a column whose
    fusion merges stages decodes in more of them unfused."""
    grew = 0
    for name in COLUMNS:
        _, enc = encs[name]
        fused, unfused = build_graph(enc), build_graph(enc, fuse=False)
        assert compile_blob(enc, backend="baseline").graph.signature == unfused.signature
        assert compile_blob(enc, backend="baseline", fuse=True).graph.signature == \
            unfused.signature
        assert compile_blob(enc, backend="kernel").graph.signature == fused.signature
        grew += len(unfused.stages) > len(fused.stages)
    assert grew >= 12


def test_geometry_reaches_the_kernel_wrappers(encs, monkeypatch):
    """Every Fully-, Group- and Non-Parallel stage of the baseline launches at
    ``BASELINE_GEOMS``; a caller's ``geometry`` goes to the patterns it names
    and leaves the others native (None)."""
    seen = []

    def spy(name, fn):
        def call(stage, env, geom=None, **kw):
            seen.append((name, geom))
            return fn(stage, env, geom, **kw)
        return call

    for name in ("fully_parallel", "group_parallel", "non_parallel"):
        monkeypatch.setattr(ops, name, spy(name[:2], getattr(ops, name)))
    for col in ("L_ORDERKEY", "O_COMMENT", "L_RETURNFLAG"):
        _, enc = encs[col]
        bufs = device_buffers(enc, "cpu")
        seen.clear()
        compile_decoder(enc, backend="baseline")(bufs)
        assert seen and all(g == Geometry(1, 128, 1) for _, g in seen)
        seen.clear()
        mine = {"gp": Geometry(2, 64, 8)}
        out = compile_decoder(enc, backend="kernel", geometry=mine)(bufs)
        assert seen and all(g == (mine["gp"] if k == "gr" else None) for k, g in seen)
        np.testing.assert_array_equal(out.numpy(), decode_on_device(enc, device="cpu").numpy())


def test_program_cache_keys_by_backend_and_geometry(encs):
    _, enc = encs["L_EXTENDEDPRICE"]
    graph = build_graph(enc)
    cache = ProgramCache()
    g1 = {"fp": Geometry(1, 128, 4)}
    progs = [cache.get(graph, "kernel"), cache.get(graph, "kernel"),
             cache.get(graph, "kernel", geometry=g1),
             cache.get(graph, "kernel", geometry=dict(g1)),
             cache.get(graph, "kernel", geometry={"fp": Geometry(2, 128, 4)}),
             cache.get(graph, "baseline"), cache.get(graph, "torch")]
    assert progs[0] is progs[1] and progs[2] is progs[3]
    assert len({id(p) for p in progs}) == 5
    assert cache.stats == {"programs": 5, "hits": 2, "misses": 5, "evictions": 0}
    assert progs[2].geometry == g1 and progs[0].geometry is None
    assert progs[5].geometry == BASELINE_GEOMS


def pinned(mod):
    cm = mod.CostModel()
    cm.spec = dataclasses.replace(cm.spec, **PIN)
    return cm


@pytest.fixture(scope="module")
def twin_pipelines(cols):
    """The reference's pipeline and the port's on the same blobs, cost models
    pinned, fed the same measured times; transfer chunks of 256 bytes."""
    names = COLUMNS
    rp = RefPipeline({n: REF_PLANS[n] for n in names},
                     executor=RefExecutor(chunk_bytes=256, cache=RC.ProgramCache(),
                                          cost_model=pinned(RCM)))
    rp.compress({n: cols[n] for n in names})
    p = ColumnPipeline({n: TABLE2_PLANS[n] for n in names}, device="cpu", chunk_bytes=256,
                       cost_model=pinned(CM))
    p.load({n: P.encoded_from_reference(rp._encoded[n]) for n in names})
    rng = np.random.default_rng(0)
    for n, t, d in zip(names, rng.uniform(1e-5, 2e-3, len(names)),
                       rng.uniform(1e-5, 5e-3, len(names))):
        rp.executor.cost_model.observe(n, float(t), float(d))
        p.executor.cost_model.observe(n, float(t), float(d))
    return rp, p


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("johnson", [False, True])
@pytest.mark.parametrize("pipeline", [False, True])
def test_modeled_makespan_equals_the_references(twin_pipelines, pipeline, johnson, chunked):
    rp, p = twin_pipelines
    want = rp.modeled_makespan(pipeline=pipeline, johnson=johnson, chunked=chunked)
    got = p.modeled_makespan(pipeline=pipeline, johnson=johnson, chunked=chunked)
    assert got == pytest.approx(want, rel=1e-12)
    jobs, rjobs = p.executor.measured_jobs(), rp.executor.measured_jobs()
    assert [(j.name, j.transfer_s, j.decompress_s) for j in jobs] == \
        [(j.name, j.transfer_s, j.decompress_s) for j in rjobs]


def test_modeled_makespan_measures_each_column_once(cols, monkeypatch):
    names = ("L_QUANTITY", "O_ORDERKEY", "L_RETURNFLAG")
    p = ColumnPipeline({n: TABLE2_PLANS[n] for n in names}, device="cpu")
    p.compress({n: cols[n] for n in names})
    seen = []
    observe = p.executor.cost_model.observe
    monkeypatch.setattr(p.executor.cost_model, "observe",
                        lambda n, t, d: (seen.append(n), observe(n, t, d))[1])
    first = p.modeled_makespan()
    assert sorted(seen) == sorted(names)
    assert p.modeled_makespan(chunked=True) > 0 and p.modeled_makespan() == first
    assert len(seen) == len(names)
    assert all(t > 0 and d > 0 for t, d in (p.executor.timings[n] for n in names))


def test_a_passed_executor_wins_and_unfused_runs_are_bitwise(cols):
    names = ("L_ORDERKEY", "O_COMMENT", "PS_SUPPKEY", "L_DISCOUNT", "L_RETURNFLAG")
    plans = {n: TABLE2_PLANS[n] for n in names}
    ex = StreamingExecutor("torch", "cpu", chunk_bytes=None, fuse=False)
    p = ColumnPipeline(plans, device="cpu", chunk_bytes=4096, fuse=True, executor=ex)
    assert p.executor is ex and not p.fuse and p.backend == "torch"
    assert p.device == torch.device("cpu")
    fused = ColumnPipeline(plans, device="cpu", fuse=True)
    assert fused.fuse and fused.executor.fuse
    p.compress({n: cols[n] for n in names})
    fused.load({n: p.encoded(n) for n in names})
    got, want = p.run(), fused.run()
    for n in names:
        assert len(ex.graph(n).stages) >= len(fused.executor.graph(n).stages)
        np.testing.assert_array_equal(bits(got[n].array.numpy()), bits(want[n].array.numpy()))
        np.testing.assert_array_equal(bits(got[n].array.numpy()), bits(cols[n]))
    assert any(len(ex.graph(n).stages) > len(fused.executor.graph(n).stages) for n in names)
