"""Decode-fused query execution in the port against the JAX reference, on the
CPU (the port's plain versions; the query kernel's card tests are in
``test_torch_cuda.py``).  Mirrors ``tests/test_query_fusion.py``:

  * Q6 fused in one launch and chunked with an uneven tail, Q1 with the
    resident L_RETURNFLAG, whole and chunked: the count lanes equal the
    reference's (and a numpy count) exactly, the float lanes within the
    reference test's ``rtol`` (1e-5 for Q6, 1e-4 for Q1; the sums are taken
    in another order), and the chunk counts, program cache keys, traffic,
    compressed and plain bytes and selectivity equal;
  * RLE per-run aggregation, an ad-hoc ``between`` projection, and small
    queries on the expression semantics the kernel program must keep (floor
    ``%`` of negatives, uint8 and int16 wrap, int-float promotion, float
    bounds on int columns, keys outside the segments dropped);
  * ``explain()`` showing ``+fused`` with the measured selectivity, the
    selectivity EWMA, and ``run(plan=...)`` of a plan with fused decisions
    decoding every column bitwise as the reference's ``run`` does;
  * the materialize-then-query engines against the reference's.
"""
import numpy as np
import pytest
import torch

import repro.core.query as RQ
from repro.core import plan as RP
from repro.core.compiler import ProgramCache as RefCache
from repro.core.compiler import compile_query_chunk_graph as ref_qchunk
from repro.core.executor import StreamingExecutor as RefExecutor
from repro.data.columns import TABLE2_PLANS as REF_PLANS
from repro.data.loader import ColumnPipeline as RefPipeline
from repro.data.queries import q1_engine as ref_q1, q6_engine as ref_q6
from repro.data.tpch import QUERY_COLUMNS, generate

import repro_torch.core.query as Q
from repro_torch.core import plan as P
from repro_torch.core.compiler import compile_query_chunk_graph, device_layout
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.loader import ColumnPipeline
from repro_torch.data.queries import Q1_PLAN, Q6_PLAN, q1_engine, q6_engine

from test_torch_cuda import SEMANTICS, semantics_columns
from test_torch_query import to_ref

RTOL = {"q1": 1e-4, "q6": 1e-5}


@pytest.fixture(scope="module")
def cols():
    return generate(scale=0.002, seed=0)


def pipelines(plans_ref, plans, chunk_bytes, **kw):
    """The reference's pipeline (its own program cache) and the port's, on the CPU."""
    rex = RefExecutor(chunk_bytes=chunk_bytes, chunk_decode=True, cache=RefCache(), **kw)
    rp = RefPipeline(plans_ref, executor=rex)
    p = ColumnPipeline(plans, device="cpu", chunk_bytes=chunk_bytes, chunk_decode=True, **kw)
    return rp, p


def tpch_pipelines(cols, q, chunk_bytes, **kw):
    names = QUERY_COLUMNS[q]
    rp, p = pipelines({n: REF_PLANS[n] for n in names}, {n: TABLE2_PLANS[n] for n in names},
                      chunk_bytes, **kw)
    rp.compress({n: cols[n] for n in names})
    p.load({n: P.encoded_from_reference(rp._encoded[n]) for n in names})
    return rp, p


def run_whole(fq, res=None):
    """The port's fused graph in one chunk launch over every item."""
    bufs = {k: torch.from_numpy(device_layout(v)) for k, v in fq.operands.items()}
    bufs.update({k: torch.from_numpy(np.asarray(v)) for k, v in (res or {}).items()})
    n = fq.graph.stages[-1].n_in
    return compile_query_chunk_graph(fq.graph, n)(bufs, 0).numpy()


def ref_run_whole(rfq, res=None):
    import jax.numpy as jnp

    bufs = {k: jnp.asarray(v) for k, v in rfq.operands.items()}
    bufs.update({k: jnp.asarray(v) for k, v in (res or {}).items()})
    return np.asarray(ref_qchunk(rfq.graph, rfq.graph.stages[-1].n_in)(bufs, 0))


def both_whole(qp, cols, names, plans_ref, plans, res=None):
    renc = {n: RP.encode(plans_ref[n], cols[n]) for n in names}
    enc = {n: P.encoded_from_reference(e) for n, e in renc.items()}
    rfq, fq = RQ.lower_query(to_ref(qp), renc), Q.lower_query(qp, enc)
    assert fq.graph.signature == rfq.graph.signature
    res = res(fq) if res else None
    return fq, run_whole(fq, res), ref_run_whole(rfq, res)


def assert_lanes(fq, acc, racc, rtol):
    """Count lanes bitwise, the other lanes within ``rtol``."""
    S = fq.n_segments
    np.testing.assert_array_equal(acc[-S:], racc[-S:])
    np.testing.assert_allclose(acc, racc, rtol=rtol)


def test_q6_fused_whole_matches_reference_and_engine(cols):
    names = QUERY_COLUMNS[6]
    fq, acc, racc = both_whole(Q6_PLAN, cols, names, REF_PLANS, TABLE2_PLANS)
    assert not fq.resident
    assert_lanes(fq, acc, racc, RTOL["q6"])
    eng = float(ref_q6({n: np.asarray(cols[n]) for n in names}))
    np.testing.assert_allclose(float(fq.finalize(acc)), eng, rtol=1e-5)
    d = cols["L_DISCOUNT"]
    m = ((cols["L_SHIPDATE"] >= 8766) & (cols["L_SHIPDATE"] < 9131)
         & (d >= np.float32(0.05)) & (d <= np.float32(0.07)) & (cols["L_QUANTITY"] < 24))
    assert fq.selected_rows(acc) == float(m.sum())


def test_q1_fused_resident_matches_reference_and_engine(cols):
    names = QUERY_COLUMNS[1]
    fq, acc, racc = both_whole(
        Q1_PLAN, cols, names, REF_PLANS, TABLE2_PLANS,
        res=lambda fq: {fq.resident_input("L_RETURNFLAG"): cols["L_RETURNFLAG"]})
    assert fq.resident == ("L_RETURNFLAG",)
    assert_lanes(fq, acc, racc, RTOL["q1"])
    eng = np.asarray(ref_q1({n: np.asarray(cols[n]) for n in names}))
    np.testing.assert_allclose(np.asarray(fq.finalize(acc)), eng, rtol=1e-4)


@pytest.mark.parametrize("q, chunk_bytes", [(6, None), (6, 1 << 12), (6, 1 << 14),
                                            (1, 1 << 12), (1, 1 << 14)])
def test_fused_run_matches_reference(q, chunk_bytes, cols):
    """``ColumnPipeline.run_query``: whole, and chunked with an uneven tail
    (the tail a second program), the resident column through ``run``."""
    rp, p = tpch_pipelines(cols, q, chunk_bytes)
    qp = {1: Q1_PLAN, 6: Q6_PLAN}[q]
    rqe, qe = rp.run_query(to_ref(qp)), p.run_query(qp)
    fq, _ = p.lower_query(qp)
    racc = np.asarray(rqe.acc)
    assert_lanes(fq, qe.acc.numpy(), racc, RTOL[qp.name])
    np.testing.assert_allclose(np.asarray(qe.result), np.asarray(rqe.result),
                               rtol=RTOL[qp.name])
    assert (qe.n_chunks, qe.decode_launches, qe.selectivity) == \
        (rqe.n_chunks, rqe.decode_launches, rqe.selectivity)
    assert (qe.traffic_bytes, qe.prefuse_traffic_bytes, qe.compressed_bytes,
            qe.plain_bytes) == (rqe.traffic_bytes, rqe.prefuse_traffic_bytes,
                                rqe.compressed_bytes, rqe.plain_bytes)
    assert qe.traffic_bytes < qe.prefuse_traffic_bytes and qe.plain_bytes > 0
    if chunk_bytes is not None:
        assert qe.n_chunks > 1
    assert set(qe.resident) == set(rqe.resident) == set(fq.resident)
    for c, r in qe.resident.items():
        np.testing.assert_array_equal(r.array.numpy(), np.asarray(rqe.resident[c].array))
    keys = {k[:-1] for k in p.executor.cache._programs if k[1] == "qchunk"}
    assert keys == {k[:-1] for k in rp.executor.cache._programs if k[1] == "qchunk"}
    assert len(keys) == (1 if qe.n_chunks == 1 or fq.n_rows % (
        p.executor.query_schedule(fq, chunk_bytes).out_sizes[0]) == 0 else 2)
    # warm: the memoised lowering and schedule give the same lanes bitwise
    again = p.run_query(qp)
    assert torch.equal(again.acc, qe.acc)


def test_searched_configuration_matches_reference(cols):
    """``chunk_bytes=None``: the chunk count comes from the cost model's
    search, which on the CPU (one resource) keeps one launch."""
    rp, p = tpch_pipelines(cols, 6, None)
    rqe, qe = rp.run_query(to_ref(Q6_PLAN)), p.run_query(Q6_PLAN)
    assert qe.n_chunks == rqe.n_chunks == 1
    assert p._query_cfg == rp._query_cfg


@pytest.mark.parametrize("window", [1, 3])
def test_window_does_not_change_the_lanes(window, cols):
    rp, p = tpch_pipelines(cols, 6, 1 << 12)
    base = p.run_query(Q6_PLAN).acc
    assert torch.equal(p.run_query(Q6_PLAN, window=window).acc, base)


def test_rle_per_run_aggregation_matches_reference():
    from repro.algos.rle import run_reduce_graph as ref_graph
    from repro_torch.algos.rle import run_reduce_graph

    rng = np.random.default_rng(3)
    counts = rng.integers(1, 60, 400)
    values = np.cumsum(rng.integers(1, 4, 400)).astype(np.int32)
    arr = np.repeat(values, counts).astype(np.int32)
    renc = RP.encode(RP.Plan("rle", children={"counts": RP.make_plan("bitpack"),
                                              "values": RP.make_plan("bitpack")}), arr)
    enc = P.encoded_from_reference(renc)
    lo = int(np.quantile(values, 0.3))
    rg = ref_graph(renc, lambda v: v >= lo, [lambda v: v * 2], digest="t")
    g = run_reduce_graph(enc, Q.Pred("root", ">=", lo),
                         [Q.Bin("*", Q.Col("root"), Q.Const(2))], digest="t")
    from repro.core.compiler import device_buffers as ref_buffers
    from repro_torch.core.compiler import device_buffers

    racc = np.asarray(ref_qchunk(rg, rg.stages[-1].n_in)(ref_buffers(renc), 0))
    acc = compile_query_chunk_graph(g, g.stages[-1].n_in)(device_buffers(enc, "cpu"), 0)
    acc = acc.numpy()
    m = arr >= lo
    np.testing.assert_allclose(acc[0], float((arr[m] * 2).sum()), rtol=1e-6)
    assert acc[1] == racc[1] == float(m.sum())
    np.testing.assert_allclose(acc, racc, rtol=1e-6)
    # spans of runs: the per-chunk partials add up to the whole
    half = 192                             # a multiple of the layout's 32
    bufs = device_buffers(enc, "cpu")
    sl = {"root/values.packed": None, "root/counts.packed": None}
    parts = []
    for start, n in ((0, half), (half, 400 - half)):
        local = dict(bufs)
        for leaf in sl:
            bw = int(bufs[leaf.replace(".packed", ".@bit_width")][0])
            lo_w, hi_w = start * bw // 32, (-(-(start + n) * bw // 32)) + 1
            local[leaf] = bufs[leaf][lo_w:hi_w].contiguous()
        parts.append(compile_query_chunk_graph(g, n)(local, start).numpy())
    np.testing.assert_array_equal(parts[0][1] + parts[1][1], acc[1])
    np.testing.assert_allclose(parts[0] + parts[1], acc, rtol=1e-6)


def test_adhoc_between_projection_matches_reference():
    rng = np.random.default_rng(1)
    n = 6000
    a = rng.integers(0, 100, n).astype(np.int32)
    b = (rng.integers(0, 500, n) / 100.0).astype(np.float32)
    plans_ref = {"A": RP.make_plan("bitpack"),
                 "B": RP.Plan("float2int", children={"ints": RP.make_plan("bitpack")})}
    plans = {"A": P.make_plan("bitpack"),
             "B": P.Plan("float2int", children={"ints": P.make_plan("bitpack")})}
    qp = Q.QueryPlan(name="adhoc", predicates=(Q.Pred("A", "between", 10, 60),),
                     aggregates=(("s", Q.Bin("*", Q.Col("B"), Q.Const(3.0))),))
    rp, p = pipelines(plans_ref, plans, 1 << 12)
    rp.compress({"A": a, "B": b})
    p.compress({"A": a, "B": b})
    rqe, qe = rp.run_query(to_ref(qp)), p.run_query(qp)
    m = (a >= 10) & (a <= 60)
    b2 = np.round(b, 2).astype(np.float32)      # float2int quantizes
    np.testing.assert_allclose(float(qe.result), float((b2[m] * 3.0).sum()), rtol=1e-5)
    assert qe.acc[-1].item() == np.asarray(rqe.acc)[-1] == float(m.sum())
    assert qe.n_chunks == rqe.n_chunks > 1


@pytest.mark.parametrize("case", list(SEMANTICS))
def test_expression_semantics_match_reference(case):
    cols = semantics_columns()
    f2i_ref = RP.Plan("float2int", children={"ints": RP.make_plan("bitpack")})
    f2i = P.Plan("float2int", children={"ints": P.make_plan("bitpack")})
    plans_ref = {k: RP.make_plan("bitpack") for k in "AFS"} | {"X": f2i_ref}
    plans = {k: P.make_plan("bitpack") for k in "AFS"} | {"X": f2i}
    qp = SEMANTICS[case]
    fq, acc, racc = both_whole(qp, cols, qp.columns(), plans_ref, plans)
    assert_lanes(fq, acc, racc, 1e-6)


def test_plan_explain_reports_fused(cols):
    rp, p = tpch_pipelines(cols, 6, 1 << 14)
    rp.run()
    p.run()                         # measured timings calibrate the model
    rqe, qe = rp.run_query(to_ref(Q6_PLAN)), p.run_query(Q6_PLAN)
    ep = p.query_plan(Q6_PLAN)
    fused = [n for n, d in ep.decisions.items() if d.fused]
    assert fused
    text = ep.explain()
    assert "+fused" in text and "sel=" in text
    for n in fused:
        np.testing.assert_allclose(ep.decisions[n].selectivity, qe.selectivity, atol=1e-6)
    assert qe.selectivity == rqe.selectivity


def test_selectivity_ewma_learns_as_the_reference(cols):
    from repro_torch.core.costmodel import DEFAULT_SELECTIVITY

    rp, p = tpch_pipelines(cols, 6, 1 << 14)
    for _ in range(2):
        rqe, qe = rp.run_query(to_ref(Q6_PLAN)), p.run_query(Q6_PLAN)
    assert qe.selectivity < DEFAULT_SELECTIVITY / 2     # Q6 is selective
    cm, rcm = p.executor.cost_model, rp.executor.cost_model
    for c in QUERY_COLUMNS[6]:
        assert cm.selectivity_for(c) != DEFAULT_SELECTIVITY
        assert cm.selectivity_for(c) == rcm.selectivity_for(c)
    assert cm.selectivity == rcm.selectivity


@pytest.mark.parametrize("q", [6, 1])
def test_run_decodes_a_fused_plan_like_the_reference(q, cols):
    """The planner marks columns ``fused`` for a pending query; ``run`` of that
    plan decodes every column (the flag is advisory), bitwise as the
    reference's ``run`` of the same plan."""
    rp, p = tpch_pipelines(cols, q, 1 << 14)
    qp = {1: Q1_PLAN, 6: Q6_PLAN}[q]
    ep, rep = p.query_plan(qp), rp.query_plan(to_ref(qp))
    assert any(d.fused for d in ep.decisions.values())
    assert sorted(n for n, d in ep.decisions.items() if d.fused) == \
        sorted(n for n, d in rep.decisions.items() if d.fused)
    res, rres = p.run(plan=ep), rp.run(plan=rep)
    assert set(res) == set(rres) == set(QUERY_COLUMNS[q])
    for n in QUERY_COLUMNS[q]:
        np.testing.assert_array_equal(res[n].array.numpy(), np.asarray(rres[n].array))
        np.testing.assert_array_equal(res[n].array.numpy(), cols[n])
        assert (res[n].n_chunks, res[n].decode_launches) == \
            (rres[n].n_chunks, rres[n].decode_launches)


def test_run_query_needs_the_resident_blobs(cols):
    rp, p = tpch_pipelines(cols, 1, None)
    fq, _ = p.lower_query(Q1_PLAN)
    with pytest.raises(ValueError, match="resident"):
        p.executor.run_query(fq)


@pytest.mark.parametrize("q", [1, 6])
def test_engines_match_reference(q, cols):
    names = QUERY_COLUMNS[q]
    got = {1: q1_engine, 6: q6_engine}[q]({n: torch.from_numpy(cols[n]) for n in names})
    want = {1: ref_q1, 6: ref_q6}[q]({n: np.asarray(cols[n]) for n in names})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    if q == 1:
        np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want)[-1])
