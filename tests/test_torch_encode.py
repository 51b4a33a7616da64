"""The port's blobs and compile front end against the JAX reference, per TPC-H column.

For each of the 24 Table-2 columns: both packages' encoders give identical
buffers (bytes, dtype, shape) and meta, identical structural signatures, and
identical fused stage lists (kinds, names, outputs, lengths, dtypes).
``auto_plan`` picks the reference's plan.
"""
import numpy as np
import pytest

from repro.core import plan as RP
from repro.core.compiler import build_graph as ref_build_graph
from repro.core.ir import structural_signature as ref_signature
from repro.data import columns as ref_columns
from repro.data.tpch import generate as ref_generate

from repro_torch.core import fusion
from repro_torch.core import plan as P
from repro_torch.core.compiler import build_graph
from repro_torch.core.ir import structural_signature
from repro_torch.core.patterns import Aux, FullyParallel, GroupParallel, NonParallel
from repro_torch.data import columns
from repro_torch.data.tpch import generate

SCALE = 0.002
COLUMNS = tuple(columns.TABLE2_PLANS)


@pytest.fixture(scope="module")
def cols():
    return generate(SCALE, seed=0)


def assert_same_blob(mine: P.Encoded, ref, path="root"):
    assert mine.codec == ref.codec, path
    assert mine.n == ref.n and np.dtype(mine.dtype) == np.dtype(ref.dtype), path
    assert sorted(mine.buffers) == sorted(ref.buffers), path
    for k, v in ref.buffers.items():
        got = mine.buffers[k]
        assert got.dtype == v.dtype and got.shape == v.shape, f"{path}.{k}"
        assert got.tobytes() == v.tobytes(), f"{path}.{k}"
    assert sorted(mine.meta) == sorted(ref.meta), path
    for k, v in ref.meta.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(mine.meta[k], v, err_msg=f"{path}@{k}")
            assert mine.meta[k].dtype == v.dtype
        else:
            assert type(mine.meta[k]) is type(v) and mine.meta[k] == v, f"{path}@{k}"
    assert sorted(mine.children) == sorted(ref.children), path
    for slot, child in ref.children.items():
        assert_same_blob(mine.children[slot], child, f"{path}/{slot}")


def stage_rows(stages):
    return [(type(st).__name__, st.name, st.out, int(st.n_out),
             np.dtype(st.out_dtype).str) for st in stages]


def test_generator_is_the_reference_generator():
    mine, ref = generate(SCALE, seed=3), ref_generate(SCALE, seed=3)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(mine[k], ref[k])


def test_table2_plans_match():
    assert list(columns.TABLE2_PLANS) == list(ref_columns.TABLE2_PLANS)
    for k, p in ref_columns.TABLE2_PLANS.items():
        assert columns.TABLE2_PLANS[k].describe() == p.describe(), k
    assert len(COLUMNS) == 24
    assert columns.TABLE2_PLANS["L_RETURNFLAG"].describe() == "ans"
    assert columns.TABLE2_PLANS["O_COMMENT"].describe() == \
        "stringdict[index=bitpack[packed=ans]]"


@pytest.mark.parametrize("name", COLUMNS)
def test_encode_matches_reference(name, cols):
    arr = cols[name]
    mine = P.encode(columns.TABLE2_PLANS[name], arr)
    ref = RP.encode(ref_columns.TABLE2_PLANS[name], arr)
    assert_same_blob(mine, ref)
    assert structural_signature(mine) == ref_signature(ref)
    assert mine.compressed_nbytes == ref.compressed_nbytes
    np.testing.assert_array_equal(P.decode_np(mine), arr)
    carried = P.encoded_from_reference(ref)
    assert_same_blob(carried, ref)
    assert structural_signature(carried) == ref_signature(ref)


@pytest.mark.parametrize("name", COLUMNS)
def test_fused_stages_match_reference(name, cols):
    ref = RP.encode(ref_columns.TABLE2_PLANS[name], cols[name])
    rg = ref_build_graph(ref)
    g = build_graph(P.encoded_from_reference(ref))
    assert stage_rows(g.stages) == stage_rows(rg.stages)
    assert g.signature == rg.signature and g.nesting == rg.nesting
    assert [b.name for b in g.buffers] == [b.name for b in rg.buffers]
    assert [(m.name, m.dtype) for m in g.meta_specs] == \
        [(m.name, m.dtype) for m in rg.meta_specs]
    for st, rst in zip(g.stages, rg.stages):
        assert tuple(getattr(st, "inputs", ())) == tuple(getattr(rst, "inputs", ()))
    # one launch per stage, plus one per FP producer folded into an Aux
    n_prod = sum(len(st.producers) for st in g.stages if isinstance(st, Aux))
    assert fusion.kernel_count(g.stages) == len(g.stages) + n_prod


def test_fused_chains_of_the_slice(cols):
    """The op chains the kernels interpret, for one column of each shape."""
    def graph(name):
        return build_graph(P.encode(columns.TABLE2_PLANS[name], cols[name]))

    def kinds(chain):
        return [op.kind for op in chain]

    (dates,) = graph("L_SHIPDATE").stages
    assert isinstance(dates, FullyParallel) and kinds(dates.chain) == ["unpack", "gather"]
    (price,) = graph("L_EXTENDEDPRICE").stages
    assert kinds(price.chain) == ["unpack", "i2f_div"]
    (supp,) = graph("PS_SUPPKEY").stages
    assert isinstance(supp, Aux)
    assert [kinds(p.chain) for p in supp.producers] == [["unpack", "gather", "unzigzag"]]
    presum, gp = graph("O_SHIPPRIORITY").stages
    assert isinstance(gp, GroupParallel) and kinds(gp.values[0]) == ["unpack"]
    assert [kinds(p.chain) for p in presum.producers] == [["unpack"]]
    ds = graph("O_ORDERKEY").stages[-1]
    assert ds.map_kind == "affine" and [kinds(c) for c in ds.values] == [["load"]] * 2
    (flag,) = graph("L_RETURNFLAG").stages
    assert isinstance(flag, NonParallel) and flag.tail == () and flag.chunk_size == 4096
    dec, reas, unpack, lengths, expand = graph("O_COMMENT").stages
    assert isinstance(dec, NonParallel) and dec.out_dtype == np.uint8
    assert kinds(reas.chain) == ["bytes"] and reas.chain[0].imm == 4
    assert np.dtype(reas.out_dtype) == np.uint32 and kinds(unpack.chain) == ["unpack"]
    assert [kinds(p.chain) for p in lengths.producers] == [["load", "span"]]
    assert expand.map_kind == "strgather" and np.dtype(expand.out_dtype) == np.uint8
    assert len(expand.extra_inputs) == 2


@pytest.mark.parametrize("kind", ["uint8", "float32", "int32"])
def test_auto_plan_matches_reference(kind, cols):
    """Every candidate is available now, so the port picks the reference's plan."""
    arr = {"uint8": cols["L_RETURNFLAG"], "float32": cols["L_DISCOUNT"],
           "int32": cols["L_QUANTITY"]}[kind]
    mine, ratio = columns.auto_plan(arr)
    ref, ref_ratio = ref_columns.auto_plan(arr)
    assert mine.describe() == ref.describe() and ratio == pytest.approx(ref_ratio)
    if kind == "uint8":
        assert "ans" in mine.describe()
