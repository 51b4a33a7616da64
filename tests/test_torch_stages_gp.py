"""Per-stage parity of the port's Group-Parallel and Aux paths against the JAX
reference: RLE (plain and bit-packed values), DeltaStride, delta cumsums, and the
fusion rules that move op chains into them (rules 2, 3 and 5).  Same method as
``test_torch_stages.py``: reference Pallas kernels in interpret mode against the
port's plain versions and kernel wrappers, bit for bit, per stage.
"""
import numpy as np
import pytest

from repro.core import plan as RP
from repro.core.compiler import build_graph as ref_build_graph

from repro_torch.core import plan as P
from repro_torch.core.compiler import build_graph
from test_torch_stages import check_blob, encode_ref

mp = RP.make_plan


def test_rle_plain_values(rng):
    counts = rng.integers(1, 40, 300)
    arr = np.repeat(rng.integers(-10**6, 10**6, 300), counts).astype(np.int32)
    check_blob(encode_ref(RP.Plan("rle", children={"counts": mp("bitpack")}), arr),
               arr)


@pytest.mark.parametrize("dist", ["even2", "random", "outlier"])
def test_rle_bitpacked_values(dist, rng):
    """Rule 2: the bit-unpack of the values runs inside the GP expansion."""
    counts = {"even2": np.full(700, 2), "random": rng.integers(1, 64, 300),
              "outlier": np.where(rng.random(500) < 0.02, 1500, 1)}[dist]
    arr = np.repeat(rng.integers(0, 1000, counts.size), counts).astype(np.int32)
    renc = encode_ref(RP.Plan("rle", children={"counts": mp("bitpack"),
                                              "values": mp("bitpack")}), arr)
    check_blob(renc, arr)
    names = [st.name for st in build_graph(P.encoded_from_reference(renc)).stages]
    assert names == ["bitpack>rle-presum", "bitpack>rle-expand"]


def test_deltastride(rng):
    arr = np.sort(rng.choice(10**6, 5000, replace=False)).astype(np.int32)
    check_blob(encode_ref(mp("deltastride"), arr), arr)


def test_deltastride_full_cascade(rng):
    arr = np.cumsum(rng.integers(1, 4, 4000)).astype(np.int32)
    plan = RP.Plan("deltastride", children={
        "starts": RP.Plan("delta", children={"deltas": mp("bitpack")}),
        "strides": mp("bitpack"), "counts": mp("bitpack")})
    check_blob(encode_ref(plan, arr), arr)


def test_delta_bitpack(rng):
    arr = rng.integers(-2**31, 2**31, 3000).astype(np.int32)   # 33-bit deltas wrap
    check_blob(encode_ref(RP.Plan("delta", children={"deltas": mp("bitpack")}), arr),
               arr)


def test_delta_dictionary_bitpack(rng):
    """PS_SUPPKEY's nesting: int64 dictionary leaves reach the device as int32."""
    arr = (np.tile(np.arange(4), 500) * 2500 + rng.integers(1, 2500, 2000)) \
        .astype(np.int32)
    plan = RP.Plan("delta", children={
        "deltas": RP.Plan("dictionary", children={"index": mp("bitpack")})})
    check_blob(encode_ref(plan, arr), arr)


def test_rule3_gp_absorbs_elementwise_consumer(rng):
    """delta[deltas=rle[...]]: the unzigzag after the expansion joins its tail."""
    arr = np.cumsum(np.repeat(rng.integers(-50, 50, 200), rng.integers(1, 20, 200))) \
        .astype(np.int32)
    plan = RP.Plan("delta", children={
        "deltas": RP.Plan("rle", children={"counts": mp("bitpack"),
                                           "values": mp("bitpack")})})
    renc = encode_ref(plan, arr)
    check_blob(renc, arr)
    ref_names = [st.name for st in ref_build_graph(renc).stages]
    port = build_graph(P.encoded_from_reference(renc)).stages
    assert [st.name for st in port] == ref_names
    assert "bitpack>rle-expand>unzigzag" in ref_names
    gp = next(st for st in port if st.name == "bitpack>rle-expand>unzigzag")
    assert [op.kind for op in gp.tail] == ["unzigzag"]
