"""Chunked and group-span streaming in the port, against the JAX reference, on
the CPU: the chunk-size formulas, the chunk layouts of every Table-2 plan, of
every candidate plan on its column and of the synthetic columns of
``tests/test_group_chunk.py``, the chunk schedules at 256 B, 4 KiB, 64 KiB and
1 MiB, and the plain versions' chunk and span forms against slices of their
whole-column results.  Outputs of the chunked path are in
``test_torch_chunk_run.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import costmodel as RC
from repro.core import plan as RP
from repro.core.compiler import ProgramCache as RefCache
from repro.core.executor import StreamingExecutor as RefExecutor
from repro.core.ir import element_chunk_layout as ref_element_layout
from repro.core.ir import group_chunk_layout as ref_group_layout
from repro.data.columns import TABLE2_PLANS as REF_PLANS, candidate_plans

from repro_torch.core import costmodel as C
from repro_torch.core import plan as P
from repro_torch.core.compiler import build_graph, device_buffers, span_stage
from repro_torch.core.executor import StreamingExecutor
from repro_torch.core.ir import element_chunk_layout, group_chunk_layout
from repro_torch.core.patterns import (IDENTITY, STRGATHER, BufSpec, GroupParallel,
                                       load)
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.tpch import generate
from repro_torch.kernels import ref
from repro_torch.kernels.ops import run_stage

COLUMNS = tuple(TABLE2_PLANS)
SIZES = (256, 4096, 1 << 16, 1 << 20)


@pytest.fixture(scope="module")
def cols():
    return {k: v for k, v in generate(0.002, seed=0).items() if k in TABLE2_PLANS}


def synthetic() -> dict[str, tuple[RP.Plan, np.ndarray]]:
    """The columns of the reference's group-chunk tests: skewed RLE runs with an
    uneven tail span, DeltaStride, rANS over int32 and over uint8 (whose last
    span is cut at the end of the stream)."""
    rng = np.random.default_rng(0)
    rle = np.repeat(rng.integers(0, 50, 501), rng.integers(1, 120, 501)).astype(np.int32)
    mono = np.arange(80_000, dtype=np.int32)
    mono[17::97] += 3
    ans = RP.Plan("ans", params={"chunk_size": 512})
    return {"rle": (RP.make_plan("rle"), rle),
            "deltastride": (RP.make_plan("deltastride"), mono),
            "ans-int32": (ans, rng.integers(0, 40, 30_000).astype(np.int32)),
            "ans-uint8": (ans, rng.integers(0, 40, 3_001).astype(np.uint8))}


def both(renc: RP.Encoded, chunk_bytes: int | None = None):
    """The reference's and the port's executors with one blob registered."""
    rex = RefExecutor(chunk_bytes=chunk_bytes, chunk_decode=True, cache=RefCache())
    rex.compile("c", renc)
    ex = StreamingExecutor("torch", "cpu", chunk_bytes=chunk_bytes, chunk_decode=True)
    ex.compile("c", P.encoded_from_reference(renc))
    return rex, ex


def spec_tuple(spec) -> tuple:
    return (spec.kind, spec.num, spec.den, spec.pad, spec.num_op)


def layout_fields(graph, group_layout, element_layout) -> dict:
    """Every layout field a schedule reads, in comparable form."""
    out = {"chunkability": graph.chunkability}
    el = element_layout(graph)
    if el is not None:
        out["element"] = (el.align, {k: spec_tuple(v) for k, v in el.tiled.items()},
                          el.whole)
    gl = group_layout(graph)
    if gl is not None:
        out["group"] = dict(
            kind=gl.kind, stage_index=gl.stage_index, n_groups=gl.n_groups,
            elems_per_group=gl.elems_per_group,
            sliced={k: spec_tuple(v) for k, v in gl.sliced.items()}, axes=gl.axes,
            whole=gl.whole, resident=gl.resident, align_groups=gl.align_groups,
            group_presum=np.asarray(gl.group_presum).tolist(),
            host_push={k: (np.asarray(v).dtype.str, np.asarray(v).tolist())
                       for k, v in gl.host_push.items()},
            span_graft=gl.span_graft)
    return out


def assert_layouts_equal(renc: RP.Encoded) -> dict:
    rex, ex = both(renc)
    want = layout_fields(rex.graph("c"), ref_group_layout, ref_element_layout)
    got = layout_fields(ex.graph("c"), group_chunk_layout, element_chunk_layout)
    assert got == want
    return got


# ------------------------------------------------------------------ formulas

@pytest.mark.parametrize("chunk_bytes", (1, 100, 256, 4096, 1 << 16, 1 << 20, 3 << 20))
def test_formulas_match_reference(chunk_bytes):
    for shape0 in (1, 2, 7, 1000, 6_000_000):
        for nbytes in (0, 1, 4 * shape0, 8 * shape0 + 3):
            assert C.rows_per_chunk(shape0, nbytes, chunk_bytes) == \
                RC.rows_per_chunk(shape0, nbytes, chunk_bytes)
    for per in (0.0, 1e-12, 0.0625, 0.40625, 1.0, 3.5, 4.0, 1e9):
        for align in (1, 2, 32, 96, 4096):
            assert C.aligned_chunk_elems(chunk_bytes, per, align) == \
                RC.aligned_chunk_elems(chunk_bytes, per, align)
            assert C.groups_per_chunk(chunk_bytes, per, align) == \
                RC.groups_per_chunk(chunk_bytes, per, align)
    assert C.GROUP_PAD_ELEMS == RC.GROUP_PAD_ELEMS
    for elems in (0, 1, 127, 128, 129, chunk_bytes, 10**7 + 1):
        assert C.pad_group_elems(elems) == RC.pad_group_elems(elems)


@pytest.mark.parametrize("name", ("rle", "deltastride", "ans-int32", "ans-uint8"))
def test_group_bytes_per_group_matches_reference(name):
    plan, arr = synthetic()[name]
    renc = RP.encode(plan, arr)
    rex, ex = both(renc)
    ops = RP.host_operands(renc)
    assert C.group_bytes_per_group(group_chunk_layout(ex.graph("c")), ops) == \
        RC.group_bytes_per_group(ref_group_layout(rex.graph("c")), ops)


# ------------------------------------------------------------------- layouts

@pytest.mark.parametrize("name", COLUMNS)
def test_table2_layouts_match_reference(name, cols):
    got = assert_layouts_equal(RP.encode(REF_PLANS[name], cols[name]))
    if name == "L_RETURNFLAG":
        assert got["group"]["kind"] == "np"


@pytest.mark.parametrize("name", COLUMNS)
def test_candidate_plan_layouts_match_reference(name, cols):
    seen = 0
    for plan in candidate_plans(cols[name].reshape(-1)):
        try:
            renc = RP.encode(plan, cols[name])
        except (TypeError, ValueError):
            continue
        assert_layouts_equal(renc)
        seen += 1
    assert seen >= 2


@pytest.mark.parametrize("name", ("rle", "deltastride", "ans-int32", "ans-uint8"))
def test_synthetic_layouts_match_reference(name):
    plan, arr = synthetic()[name]
    got = assert_layouts_equal(RP.encode(plan, arr))
    assert got["chunkability"] == "group"


def test_stringdict_graft_is_the_producer_chain(cols):
    """StringDict over a bit-packed index (a candidate plan of O_COMMENT): the
    reference grafts the index's bitpack producer into each span, since the
    index has a second consumer (the word lengths the host-pushed presum
    replaces) and fusion rule 2 could not absorb it.  The port's span stage
    carries the producer's chain in place of the value chain's LOAD."""
    renc = RP.encode(RP.Plan("stringdict", children={"index": RP.make_plan("bitpack")}),
                     cols["O_COMMENT"])
    got = assert_layouts_equal(renc)["group"]
    assert got["span_graft"] and list(got["host_push"]) and not got["resident"]
    graph = StreamingExecutor("torch", "cpu").compile(
        "c", P.encoded_from_reference(renc)).graph
    (name, gi), = group_chunk_layout(graph).span_graft.items()
    st = span_stage(graph)
    assert st.values == (graph.stages[gi].chain,)
    assert st.value_inputs == graph.stages[gi].inputs


# ----------------------------------------------------------------- schedules

def schedule_fields(s) -> dict | None:
    if s is None:
        return None
    return {f: getattr(s, f) for f in ("out_starts", "out_sizes", "whole", "kind",
                                       "g_starts", "g_sizes", "pad_sizes", "axes",
                                       "row_caps")} | {
        "slices": {k: [tuple(map(int, p)) for p in v] for k, v in s.slices.items()},
        "host_push": sorted(s.host_push), "n_chunks": s.n_chunks}


def assert_schedules_equal(renc: RP.Encoded, chunk_bytes: int):
    rex, ex = both(renc, chunk_bytes)
    want, got = rex.chunk_schedule("c"), ex.chunk_schedule("c")
    assert schedule_fields(got) == schedule_fields(want)
    assert ex.chunk_schedule("c", None) is None
    if got is None:
        assert ex.n_transfer_chunks("c", chunk_bytes) == rex._n_chunks("c", chunk_bytes)
    return got


@pytest.mark.parametrize("chunk_bytes", SIZES)
@pytest.mark.parametrize("name", COLUMNS)
def test_table2_schedules_match_reference(name, chunk_bytes, cols):
    sched = assert_schedules_equal(RP.encode(REF_PLANS[name], cols[name]),
                                   chunk_bytes)
    if chunk_bytes == 1 << 20:
        assert sched is None                 # one chunk covers the column here


@pytest.mark.parametrize("chunk_bytes", SIZES)
@pytest.mark.parametrize("name", ("rle", "deltastride", "ans-int32", "ans-uint8"))
def test_synthetic_schedules_match_reference(name, chunk_bytes):
    plan, arr = synthetic()[name]
    sched = assert_schedules_equal(RP.encode(plan, arr), chunk_bytes)
    if chunk_bytes == 256:
        assert sched.kind == "group" and sched.n_chunks > 2


# --------------------------------------------------- plain chunk / span forms

def test_plain_fp_chunks_equal_slices_of_the_whole(cols):
    """A bit-packed chunk on its own slice of words, from word 0, equals the
    whole column's range, for every chunk of a 256-byte schedule."""
    renc = RP.encode(REF_PLANS["L_EXTENDEDPRICE"], cols["L_EXTENDEDPRICE"])
    ex = StreamingExecutor("torch", "cpu", chunk_bytes=256, chunk_decode=True)
    ex.compile("c", P.encoded_from_reference(renc))
    (st,) = ex.graph("c").stages
    env = device_buffers(P.encoded_from_reference(renc), "cpu")
    whole = ref.fully_parallel_torch(st, env)
    sched = ex.chunk_schedule("c")
    assert sched.n_chunks > 10
    for s, n, (lo, hi) in zip(sched.out_starts, sched.out_sizes,
                              sched.slices[st.chain[0].bufs[0]]):
        local = dict(env)
        local[st.chain[0].bufs[0]] = env[st.chain[0].bufs[0]][lo:hi]
        got = ref.fully_parallel_torch(st, local, n)
        assert torch.equal(got.view(torch.int32), whole[s:s + n].view(torch.int32))


def _gp_whole_and_env(name: str):
    plan, arr = synthetic()[name]
    enc = P.encoded_from_reference(RP.encode(plan, arr))
    graph = build_graph(enc)
    env = device_buffers(enc, "cpu")
    layout = group_chunk_layout(graph)
    for st in graph.stages[:layout.stage_index]:
        env[st.out] = run_stage(st, env, "torch")
    gst = graph.stages[layout.stage_index]
    return gst, env, ref.group_parallel_torch(gst, env), layout, arr


@pytest.mark.parametrize("name", ("rle", "deltastride"))
def test_plain_gp_spans_equal_slices_of_the_whole(name):
    gst, env, whole, layout, arr = _gp_whole_and_env(name)
    assert torch.equal(whole, torch.from_numpy(arr))
    presum = np.asarray(layout.group_presum)
    rng = np.random.default_rng(1)
    for _ in range(25):
        g0 = int(rng.integers(0, gst.n_groups))
        g1 = int(rng.integers(g0 + 1, gst.n_groups + 1))
        start, stop = int(presum[g0]), int(presum[g1])
        # n_valid below the span's own size too, as a padded launch's prefix
        n_valid = int(rng.integers(1, stop - start + 1))
        local = dict(env)
        for k in gst.value_inputs:
            local[k] = env[k][g0:g1]
        got = ref.group_parallel_torch(gst, local, start, g0, n_valid)
        assert torch.equal(got, whole[start:start + n_valid])


def test_plain_np_spans_equal_slices_of_the_whole():
    """rANS spans on their stripes, row-capped as the schedule moves them, the
    last one cut at the end of the stream."""
    plan, arr = synthetic()["ans-uint8"]
    renc = RP.encode(plan, arr)
    ex = StreamingExecutor("torch", "cpu", chunk_bytes=512, chunk_decode=True)
    ex.compile("c", P.encoded_from_reference(renc))
    (st,) = ex.graph("c").stages
    env = device_buffers(P.encoded_from_reference(renc), "cpu")
    whole = ref.non_parallel_torch(st, env)
    assert torch.equal(whole, torch.from_numpy(arr))
    sched = ex.chunk_schedule("c")
    ops = P.host_operands(P.encoded_from_reference(renc))
    assert sched.n_chunks > 2 and sched.out_sizes[-1] < sched.pad_sizes[-1]
    for k in range(sched.n_chunks):
        local = dict(env)
        for leaf in (st.streams, st.states):
            piece = sched.piece(np.asarray(ops[leaf]), leaf, k)
            local[leaf] = torch.from_numpy(np.ascontiguousarray(piece).view(
                np.int32 if piece.dtype == np.uint32 else piece.dtype))
        assert local[st.streams].shape[0] == sched.row_caps[st.streams][k]
        s, n = sched.out_starts[k], sched.out_sizes[k]
        got = ref.non_parallel_torch(st, local, sched.g_sizes[k], n)
        assert torch.equal(got, whole[s:s + n])


@pytest.mark.parametrize("offs_dtype", (torch.int32, torch.uint16))
def test_plain_strgather_offsets_of_any_width(offs_dtype):
    """STRGATHER reads the word offsets through ``ref.take``, so a uint16
    offsets buffer decodes (on CUDA too, where torch indexes no uint16)."""
    rng = np.random.default_rng(2)
    chars = torch.from_numpy(rng.integers(0, 256, 3000).astype(np.uint8))
    offs = torch.from_numpy(np.sort(rng.integers(0, 2900, 60)).astype(np.int64))
    words = torch.from_numpy(rng.integers(0, 59, 400).astype(np.int32))
    counts = torch.diff(offs)[words.long()]
    presum = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)])
    st = GroupParallel(presum="presum", value_inputs=("words",),
                       value_specs=(BufSpec("tile"),), values=((load("words"),),),
                       map_kind=STRGATHER, extra_inputs=("chars", "offs"), out="out",
                       n_out=int(presum[-1]), n_groups=400, out_dtype=np.uint8)
    env = {"presum": presum.to(torch.int32), "words": words, "chars": chars,
           "offs": offs.to(offs_dtype)}
    want = torch.cat([chars[int(offs[w]):int(offs[w + 1])] for w in words.tolist()])
    assert torch.equal(ref.group_parallel_torch(st, env), want)
    assert torch.equal(ref.group_parallel_torch(st, env, 7, 0, 50), want[7:57])
    assert st.map_kind != IDENTITY
