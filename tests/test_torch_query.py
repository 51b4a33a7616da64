"""Decode-fused queries in the port against the JAX reference, on the CPU:
lowering, fusion and layouts (execution is ``test_torch_query_run.py``).

  * the query IR: ``QueryPlan.digest`` byte-identical, ``columns`` and
    ``Pred.int_range`` equal, for Q1, Q6 and ad-hoc plans;
  * ``lower_query``: the fused graph's ``signature`` and ``nesting``, every
    stage's name and inputs, the Reduce's input specs, the fused and resident
    columns, the shipped operands and buffer/meta specs equal the reference's,
    for Q1 (resident L_RETURNFLAG, compressed-domain L_SHIPDATE), Q6
    (compressed-domain L_SHIPDATE and L_QUANTITY) and a post-decode
    predicate; no fused stage writes a row-sized output;
  * ``query_chunk_layout`` and ``fusion.hbm_traffic_bytes`` (fused and before
    fusion) equal the reference's; the per-run RLE graph's signature and
    layout too;
  * the codec helpers: ``dictionary.code_bounds`` equals the reference's, and
    ``bitpack.compare_stage`` gives the reference's masks, and the true ones
    where an int32 ``v + base`` would wrap;
  * the query kernel's program (compiled on the host): common subexpressions
    share registers, and a query with more buffers than the argument struct
    holds raises; queries wider than Q1 (17 lanes; 4 x 16, 8 x 32 and 2 x 256
    accumulators) build a program and equal the reference's results, and a
    column-free aggregate gives the constant times the count (the reference
    raises on it).

TPC-H data at scale 0.002, seed 0, as ``tests/test_query_fusion.py``.
"""
import numpy as np
import pytest
import torch

import repro.core.query as RQ
from repro.algos import bitpack as RB
from repro.algos import dictionary as RD
from repro.algos.rle import run_reduce_graph as ref_run_reduce_graph
from repro.core import plan as RP
from repro.core.fusion import hbm_traffic_bytes as ref_traffic
from repro.core.ir import query_chunk_layout as ref_layout
from repro.data.columns import TABLE2_PLANS as REF_PLANS
from repro.data.queries import Q1_PLAN as REF_Q1, Q6_PLAN as REF_Q6
from repro.data.tpch import QUERY_COLUMNS, generate

import repro_torch.core.query as Q
from repro_torch.algos import bitpack as B
from repro_torch.algos import dictionary as D
from repro_torch.algos.rle import run_reduce_graph
from repro_torch.core import plan as P
from repro_torch.core.fusion import hbm_traffic_bytes
from repro_torch.core.ir import query_chunk_layout
from repro_torch.core.patterns import Reduce
from repro_torch.data.queries import Q1_PLAN, Q6_PLAN
from repro_torch.kernels import cuda, ref
from repro_torch.kernels.query_reduce import program


def to_ref(x):
    """The reference's twin of a port query object (plans, predicates, trees)."""
    if isinstance(x, Q.QueryPlan):
        return RQ.QueryPlan(x.name, tuple(map(to_ref, x.predicates)),
                            tuple((lbl, to_ref(e)) for lbl, e in x.aggregates),
                            to_ref(x.group_key), x.n_segments, x.keep_count_lane)
    if isinstance(x, Q.Pred):
        return RQ.Pred(x.col, x.op, x.value, x.value2)
    if isinstance(x, Q.Col):
        return RQ.Col(x.name, x.cast)
    if isinstance(x, Q.Const):
        return RQ.Const(x.value)
    if isinstance(x, Q.Bin):
        return RQ.Bin(x.op, to_ref(x.a), to_ref(x.b))
    assert x is None
    return None


# a post-decode mask: a float predicate on a column no aggregate reads
POSTDECODE = Q.QueryPlan(
    name="postdecode",
    predicates=(Q.Pred("L_TAX", "<", 0.045), Q.Pred("L_QUANTITY", ">", 10.5)),
    aggregates=(("s", Q.Bin("*", Q.Col("L_EXTENDEDPRICE"), Q.Const(2))),))
PLANS = {"q1": (Q1_PLAN, 1), "q6": (Q6_PLAN, 6), "postdecode": (POSTDECODE, 1)}


@pytest.fixture(scope="module")
def cols():
    return generate(scale=0.002, seed=0)


def lowered(cols, which):
    qp, q = PLANS[which]
    renc = {n: RP.encode(REF_PLANS[n], cols[n]) for n in QUERY_COLUMNS[q]}
    enc = {n: P.encoded_from_reference(e) for n, e in renc.items()}
    return RQ.lower_query(to_ref(qp), renc), Q.lower_query(qp, enc), enc


@pytest.mark.parametrize("qp", [Q1_PLAN, Q6_PLAN, POSTDECODE], ids=lambda q: q.name)
def test_query_plan_digest_matches_reference(qp):
    rq = to_ref(qp)
    assert qp.digest() == rq.digest()
    assert qp.columns() == rq.columns()
    for p, rp in zip(qp.predicates, rq.predicates):
        assert p.int_range() == rp.int_range()


def test_table_query_plans_are_the_reference_plans():
    assert Q1_PLAN.digest() == REF_Q1.digest()
    assert Q6_PLAN.digest() == REF_Q6.digest()


@pytest.mark.parametrize("which", list(PLANS))
def test_lowering_matches_reference(which, cols):
    rfq, fq, _ = lowered(cols, which)
    g, rg = fq.graph, rfq.graph
    assert (g.signature, g.nesting, g.n_out, g.out, g.out_dtype, g.fused) == \
        (rg.signature, rg.nesting, rg.n_out, rg.out, rg.out_dtype, rg.fused)
    assert g.signature.endswith("+qfused") and g.nesting == f"query[{fq.qplan.name}]"
    assert [(s.name, s.inputs, s.out, s.n_out) for s in g.stages] == \
        [(s.name, s.inputs, s.out, s.n_out) for s in rg.stages]
    assert [s.kind for s in g.stages[-1].specs] == [s.kind for s in rg.stages[-1].specs]
    assert [(s.name, s.out, s.n_out, np.dtype(s.out_dtype)) for s in fq.prefuse_stages] == \
        [(s.name, s.out, s.n_out, np.dtype(s.out_dtype)) for s in rfq.prefuse_stages]
    assert (fq.fused_cols, fq.resident, fq.n_rows, fq.n_lanes, fq.n_segments) == \
        (rfq.fused_cols, rfq.resident, rfq.n_rows, rfq.n_lanes, rfq.n_segments)
    assert g.buffers == tuple(type(g.buffers[0])(**vars(b)) for b in rg.buffers)
    assert [(m.name, m.shape, m.dtype) for m in g.meta_specs] == \
        [(m.name, m.shape, m.dtype) for m in rg.meta_specs]
    assert list(fq.operands) == list(rfq.operands)
    for k, v in fq.operands.items():
        np.testing.assert_array_equal(v, rfq.operands[k])
    # the decompressed columns never exist in device memory
    assert all(getattr(st, "n_out", 0) != fq.n_rows for st in g.stages)
    assert fq.resident_input("X") == rfq.resident_input("X")


def test_lowering_routes_each_column_as_the_reference(cols):
    rfq1, fq1, _ = lowered(cols, "q1")
    rfq6, fq6, _ = lowered(cols, "q6")
    assert fq1.resident == ("L_RETURNFLAG",)       # rANS: decoded, read by row
    assert not fq6.resident                        # all four Q6 columns fuse
    red6 = fq6.graph.stages[-1]
    masks = {r.col: r.chain for r in red6.roles if r.kind == "mask"}
    # compressed domain: dictionary codes (L_SHIPDATE) and packed words
    # (L_QUANTITY) compared before any decode
    assert set(masks) == {"L_SHIPDATE", "L_QUANTITY"}
    assert all([op.kind for op in c] == ["unpack_raw", "range"] for c in masks.values())
    assert masks["L_SHIPDATE"][0].bufs[0] == "L_SHIPDATE/index.packed"
    # L_DISCOUNT is aggregated: a value role with its predicate inline
    assert [p.col for p in red6.preds] == ["L_DISCOUNT"]
    red1 = fq1.graph.stages[-1]
    assert [r.kind for r in red1.roles if r.col == "L_RETURNFLAG"] == ["row"]


def test_post_decode_mask_grafts_the_decode_into_the_predicate(cols):
    _, fq, _ = lowered(cols, "postdecode")
    red = fq.graph.stages[-1]
    tax = next(r for r in red.roles if r.col == "L_TAX")
    assert tax.kind == "mask" and [op.kind for op in tax.chain] == ["unpack", "i2f_div", "test"]
    assert any(s.name.startswith("pred[L_TAX]") for s in fq.prefuse_stages)


@pytest.mark.parametrize("which", list(PLANS))
def test_query_chunk_layout_and_traffic_match_reference(which, cols):
    rfq, fq, _ = lowered(cols, which)
    lay, rlay = query_chunk_layout(fq.graph), ref_layout(rfq.graph)
    assert lay is not None and lay.tiled
    assert (lay.align, lay.whole, lay.resident, lay.n_rows) == \
        (rlay.align, rlay.whole, rlay.resident, rlay.n_rows)
    assert {k: vars(v) for k, v in lay.tiled.items()} == \
        {k: vars(v) for k, v in rlay.tiled.items()}
    assert query_chunk_layout(fq.graph) is lay          # memoised
    res = {fq.resident_input(c): np.zeros(fq.n_rows, np.uint8) for c in fq.resident}
    bufs = {**fq.operands, **res}
    pre, post = (hbm_traffic_bytes(fq.prefuse_stages, bufs),
                 hbm_traffic_bytes(fq.graph.stages, bufs))
    assert (pre, post) == (ref_traffic(rfq.prefuse_stages, bufs),
                           ref_traffic(rfq.graph.stages, bufs))
    # fusion removed at least the decoded columns' round trips
    encs = {c: lowered(cols, which)[2][c] for c in fq.fused_cols}
    assert pre - post >= sum(e.plain_nbytes for e in encs.values())


def test_rle_run_graph_matches_reference():
    rng = np.random.default_rng(3)
    counts = rng.integers(1, 60, 400)
    values = np.cumsum(rng.integers(1, 4, 400)).astype(np.int32)
    arr = np.repeat(values, counts).astype(np.int32)
    rplan = RP.Plan("rle", children={"counts": RP.make_plan("bitpack"),
                                     "values": RP.make_plan("bitpack")})
    renc = RP.encode(rplan, arr)
    enc = P.encoded_from_reference(renc)
    lo = int(np.quantile(values, 0.3))
    rg = ref_run_reduce_graph(renc, lambda v: v >= lo, [lambda v: v * 2], digest="t")
    g = run_reduce_graph(enc, Q.Pred("root", ">=", lo),
                         [Q.Bin("*", Q.Col("root"), Q.Const(2))], digest="t")
    assert (g.signature, g.nesting, g.n_out) == (rg.signature, rg.nesting, rg.n_out)
    assert [(s.name, s.inputs) for s in g.stages] == [(s.name, s.inputs) for s in rg.stages]
    lay, rlay = query_chunk_layout(g), ref_layout(rg)
    assert (lay.align, lay.whole, lay.resident, lay.n_rows) == \
        (rlay.align, rlay.whole, rlay.resident, rlay.n_rows) and lay.n_rows == 400
    assert all(getattr(st, "n_out", 0) != enc.n for st in g.stages)


@pytest.mark.parametrize("lo, hi", [(None, 20220), (20100, None), (20100, 20300),
                                    (0, 1), (30000, 40000), (None, None)])
def test_code_bounds_match_reference(lo, hi):
    d = np.unique(np.random.default_rng(0).integers(20000, 21000, 500)).astype(np.int32)
    assert D.code_bounds(d, lo, hi) == RD.code_bounds(d, lo, hi)


@pytest.mark.parametrize("lo, hi", [(None, 24), (10, None), (3, 47), (60, 70), (None, 1)])
def test_compare_stage_matches_reference(lo, hi):
    arr = np.random.default_rng(1).integers(1, 51, 3001).astype(np.int32)
    renc = RP.encode(RP.make_plan("bitpack"), arr)
    enc = P.encoded_from_reference(renc)
    names = ("c.packed", "c.@bit_width", "c.@base", "c.mask")
    rst = RB.compare_stage(renc, *names, lo, hi)
    st = B.compare_stage(enc, *names, lo, hi)
    assert (st.name, st.inputs, st.n_out) == (rst.name, rst.inputs, rst.n_out)
    ops = RP.host_operands(renc)
    rmask = np.asarray(rst.run_jnp({k.replace("root", "c"): v for k, v in ops.items()}))
    env = {k.replace("root", "c"): torch.from_numpy(P_layout(v)) for k, v in ops.items()}
    mask = ref.fully_parallel_torch(st, env).numpy()
    truth = np.ones(arr.shape, bool)
    if lo is not None:
        truth &= arr >= lo
    if hi is not None:
        truth &= arr < hi
    np.testing.assert_array_equal(mask, rmask)
    np.testing.assert_array_equal(mask, truth)


def P_layout(v):
    from repro_torch.core.compiler import device_layout
    return device_layout(v)


def test_compare_stage_is_exact_where_v_plus_base_wraps():
    """Bit width 32 with a base near INT32_MIN: ``v + base`` as int32 wraps for
    the large fields, so a compare on ``UNPACK``'s result would be wrong; the
    field against the rebased bounds in 64 bits is not."""
    rng = np.random.default_rng(2)
    arr = np.concatenate([[-2**31 + 5, 2**31 - 3],
                          rng.integers(-2**31, 2**31, 4000)]).astype(np.int32)
    enc = P.encode(P.make_plan("bitpack"), arr)
    assert enc.meta["bit_width"] == 32
    for lo, hi in [(-2**31 + 6, None), (None, 2**31 - 3), (-5, 7 * 10**8), (0, None)]:
        st = B.compare_stage(enc, "root.packed", "root.@bit_width", "root.@base",
                             "m", lo, hi)
        env = {k: torch.from_numpy(P_layout(v)) for k, v in P.host_operands(enc).items()}
        got = ref.fully_parallel_torch(st, env).numpy()
        want = np.ones(arr.shape, bool)
        if lo is not None:
            want &= arr.astype(np.int64) >= lo
        if hi is not None:
            want &= arr.astype(np.int64) < hi
        np.testing.assert_array_equal(got, want)


def test_query_program_shares_subexpressions(cols):
    """Q1's kernel program: one register per role, the discounted price
    computed once for two lanes, the key a chain of int32 operations."""
    _, fq, _ = lowered(cols, "q1")
    red = fq.graph.stages[-1]
    env = {k: torch.from_numpy(P_layout(v)) for k, v in fq.operands.items()}
    env[fq.resident_input("L_RETURNFLAG")] = torch.zeros(fq.n_rows, dtype=torch.uint8)
    prog = program(red, env)
    assert len(prog.roles) == len(red.roles) == 7
    assert [p[1:3] for p in prog.preds] == []           # L_SHIPDATE is a range mask
    ops = [i[0] for i in prog.instrs]
    assert ops.count(4) == 3          # ep * (1 - d), (..) * (1 + t), key * 2
    assert len(prog.lanes) == 4 and prog.key >= len(red.roles)
    assert prog.n_regs == len(red.roles) + len(prog.instrs)   # one per role and instruction
    assert prog.acc_place == "shared" and prog.n_acc == 5 * 8
    assert program(red, env) is prog                     # built once per stage


def test_query_program_refuses_more_buffers_than_the_struct_holds(cols):
    """The launch struct's buffer slots are the generated kernel's one limit
    on roles and ops: Q6's roles seven times over need more than it holds."""
    import dataclasses

    _, fq, _ = lowered(cols, "q6")
    red = fq.graph.stages[-1]
    env = {k: torch.from_numpy(P_layout(v)) for k, v in fq.operands.items()}
    big = dataclasses.replace(red, roles=red.roles * 7)
    assert isinstance(big, Reduce)
    with pytest.raises(ValueError, match=f"exceed the generated kernel's {cuda.QG_MAX_BUFS}"):
        program(big, env)


def wide_pipelines(cols, qp):
    """The reference's pipeline (its own program cache) and the port's on the
    CPU, with the plan's columns compressed by the reference and loaded into
    the port."""
    from repro.core.compiler import ProgramCache as RefCache
    from repro.core.executor import StreamingExecutor as RefExecutor
    from repro.data.loader import ColumnPipeline as RefPipeline

    from repro_torch.data.columns import TABLE2_PLANS
    from repro_torch.data.loader import ColumnPipeline

    names = qp.columns()
    rp = RefPipeline({n: REF_PLANS[n] for n in names},
                     executor=RefExecutor(cache=RefCache()))
    rp.compress({n: cols[n] for n in names})
    p = ColumnPipeline({n: TABLE2_PLANS[n] for n in names}, device="cpu")
    p.load({n: P.encoded_from_reference(rp._encoded[n]) for n in names})
    return rp, p


@pytest.mark.parametrize("name,place,n_acc", [("lanes17", "registers", 18),
                                              ("lanes4_seg16", "shared", 80),
                                              ("lanes7_seg32", "shared", 256),
                                              ("lanes1_seg256", "global", 512)])
def test_wide_queries_build_a_program_and_match_the_reference(cols, name, place, n_acc):
    """Queries past the removed interpreter's limits (17 lanes; 4 lanes x 16
    segments; 256 and 512 accumulators, more than a block has threads) build
    a program and its generated source, keep their accumulators where the
    kernel's layout says, and run on the CPU to the reference's result:
    counts exactly, lanes within rtol 1e-4 (sums in another order)."""
    from repro_torch.data.queries import WIDE_PLANS

    qp = WIDE_PLANS[name]
    rp, p = wide_pipelines(cols, qp)
    fq, _ = p.lower_query(qp)
    red = fq.graph.stages[-1]
    env = {k: torch.from_numpy(P_layout(v)) for k, v in fq.operands.items()}
    prog = program(red, env)
    assert (prog.acc_place, prog.n_acc, len(prog.lanes)) == (place, n_acc, len(qp.aggregates))
    src = prog.source
    assert f"kLanes = {len(qp.aggregates)};" in src and \
        f"kSegments = {qp.n_segments};" in src
    got, want = p.run_query(qp), rp.run_query(to_ref(qp))
    np.testing.assert_array_equal(np.asarray(got.acc)[-qp.n_segments:],
                                  np.asarray(want.acc)[-qp.n_segments:])
    np.testing.assert_allclose(np.asarray(got.result), np.asarray(want.result), rtol=1e-4)


def test_column_free_aggregate_is_the_constant_times_the_count(cols):
    """An aggregate of a constant alone: the port sums it over the selected
    rows (2.5 x the count); the reference's reduce raises on the float
    (``repro/core/query.py`` ``reduce_fn`` calls ``.astype`` on it)."""
    from repro_torch.data.queries import CONST_LANE_PLAN

    rp, p = wide_pipelines(cols, CONST_LANE_PLAN)
    got = p.run_query(CONST_LANE_PLAN)
    count = int((cols["L_QUANTITY"] < 24).sum())
    assert float(got.acc[-1]) == count
    assert float(got.result) == 2.5 * count
    with pytest.raises(AttributeError, match="astype"):
        rp.run_query(to_ref(CONST_LANE_PLAN))


def test_pack_chain_refuses_query_ops_outside_the_query_kernel():
    from repro_torch.core.patterns import in_range, load, predicate, unpack_raw

    dev = torch.device("cpu")
    env = {"p": torch.zeros(4, dtype=torch.int32), "bw": torch.ones(1, dtype=torch.int32),
           "base": torch.zeros(1, dtype=torch.int32)}
    for chain in ((unpack_raw("p", "bw"),), (load("p"), in_range("base", -3, 2**40)),
                  (load("p"), predicate((), np.int32))):
        with pytest.raises(ValueError, match="do not take"):
            cuda.pack_chain(chain, env, dev)
    # the query kernels compile a range in; its bounds are checked all the same
    with pytest.raises(ValueError, match="64-bit"):
        cuda.check_op_types(in_range("base", None, 2**63), env)
