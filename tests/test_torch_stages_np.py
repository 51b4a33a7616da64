"""Per-stage parity of the port's rANS (Non-Parallel) and StringDict paths against
the JAX reference, and fusion rule 4.

Same method as ``test_torch_stages.py``: the reference runs every fused stage
through its Pallas kernels in interpret mode (as ``tests/test_kernels.py`` runs
the Non-Parallel kernel), the port runs the same stages through its plain
versions and its kernel wrappers (which take the plain version for CPU tensors),
and every stage output must match bit for bit.  Inputs are seeded numpy.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import plan as RP
from repro.core.compiler import build_graph as ref_build_graph

from repro_torch.core import plan as P
from repro_torch.core.compiler import build_graph, device_buffers
from repro_torch.core.fusion import fuse
from repro_torch.core.patterns import (BufSpec, FullyParallel, NonParallel, gather,
                                       load)
from repro_torch.kernels import ref
from repro_torch.kernels.non_parallel import non_parallel
from repro_torch.kernels.ops import run_stage
from test_torch_stages import assert_bitwise, check_blob, encode_ref

mp = RP.make_plan


def ans_plan(chunk: int) -> RP.Plan:
    return RP.Plan("ans", params={"chunk_size": chunk})


def stage_names(renc) -> list[str]:
    return [st.name for st in build_graph(P.encoded_from_reference(renc)).stages]


def wrapped_i32(a) -> np.ndarray:
    return ((np.asarray(a, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


@pytest.mark.parametrize("chunk", [256, 4096])
@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32", "int64"])
def test_ans_stages(dtype, chunk, rng):
    n = 5000                         # not a multiple of either chunk size
    if dtype == "uint8":
        arr = rng.choice(np.arange(65, 75, dtype=np.uint8), n)
    elif dtype == "float32":
        arr = rng.normal(0, 1e3, n).astype(np.float32)
    else:
        arr = rng.integers(-2**31, 2**31, n).astype(dtype)
        if dtype == "int64":
            arr[::7] += 2**40        # the high word is dropped, as in the reference
    renc = encode_ref(ans_plan(chunk), arr)
    assert renc.meta["n_bytes"] % chunk != 0
    want = wrapped_i32(arr) if dtype == "int64" else arr
    check_blob(renc, want)
    assert stage_names(renc) == (["ans-decode"] if dtype == "uint8"
                                 else ["ans-decode", "byte-reassemble"])


@pytest.mark.parametrize("chunk", [256, 4096])
def test_ans_skewed_alphabet(chunk, rng):
    """One symbol takes almost all of the probability: long runs between renorms."""
    arr = np.where(rng.random(20000) < 0.995, 78, rng.integers(0, 256, 20000)) \
        .astype(np.uint8)
    check_blob(encode_ref(ans_plan(chunk), arr), arr)


@pytest.mark.parametrize("n", [1, 4096, 12288])
def test_ans_single_symbol(n):
    arr = np.full(n, 82, np.uint8)
    renc = encode_ref(ans_plan(4096), arr)
    if n % 4096 == 0:   # no zero padding: one symbol holds the whole scale
        assert int(renc.buffers["freq_tab"][82]) == 4096
    check_blob(renc, arr)


def test_ans_matches_numpy_oracle(rng):
    arr = rng.integers(0, 7, 3000).astype(np.uint8)
    penc = P.encode(P.Plan("ans", params={"chunk_size": 256}), arr)
    np.testing.assert_array_equal(P.decode_np(penc), arr)
    (st,) = build_graph(penc).stages
    got = ref.non_parallel_torch(st, device_buffers(penc, "cpu"))
    assert got.dtype == torch.uint8 and got.shape == (3000,)
    np.testing.assert_array_equal(got.numpy(), arr)


def comment_text(rng, n_rows: int, end_with_delimiter: bool = True) -> np.ndarray:
    """O_COMMENT-like text: lower-case words, spaces and periods."""
    words = ["furiously", "quickly", "regular", "deposits", "sleep", "the",
             "carefully", "final", "packages", "ironic", "accounts", "wake", "bold"]
    rows = []
    for _ in range(n_rows):
        k = int(rng.integers(3, 12))
        rows.append(" ".join(rng.choice(words, k)) + rng.choice([". ", " ", "."]))
    text = "".join(rows)
    if not end_with_delimiter:
        text = text.rstrip(". ") + " trailing"
    return np.frombuffer(text.encode(), np.uint8).copy()


@pytest.mark.parametrize("end_with_delimiter", [True, False])
def test_stringdict_bitpack(end_with_delimiter, rng):
    arr = comment_text(rng, 300, end_with_delimiter)
    renc = encode_ref(RP.Plan("stringdict", children={"index": mp("bitpack")}), arr)
    check_blob(renc, arr)
    assert stage_names(renc) == ["bitpack", "word-lengths>sd-presum",
                                 "stringdict-expand"]


def test_stringdict_o_comment_plan(rng):
    """O_COMMENT's nesting: stringdict[index=bitpack[packed=ans]]."""
    arr = comment_text(rng, 600)
    plan = RP.Plan("stringdict", children={
        "index": RP.Plan("bitpack", children={"packed": mp("ans")})})
    renc = encode_ref(plan, arr)
    check_blob(renc, arr)
    assert stage_names(renc) == [st.name for st in ref_build_graph(renc).stages] == [
        "ans-decode", "byte-reassemble", "bitpack", "word-lengths>sd-presum",
        "stringdict-expand"]


def test_stringdict_plain_leaf(rng):
    arr = comment_text(rng, 50, end_with_delimiter=False)
    check_blob(encode_ref(mp("stringdict"), arr), arr)


# ------------------------------------------------------------- fusion rule 4

def rule4_stages(n: int, chunk: int, rng):
    """A hand-built NP -> FP(LOAD -> GATHER) list.  The consumer has one input
    (the reference's condition for rules 3/4); its table is a constant."""
    syms = rng.integers(0, 40, n).astype(np.uint8)
    penc = P.encode(P.Plan("ans", params={"chunk_size": chunk}), syms)
    env = device_buffers(penc, "cpu")
    (dec,) = build_graph(penc).stages
    table = rng.integers(-2**31, 2**31, 40).astype(np.int32)
    env["table"] = torch.from_numpy(table)
    dec = dataclasses.replace(dec, out="syms")
    cons = FullyParallel(chain=(load("syms"), gather("table")), inputs=("syms",),
                         specs=(BufSpec("tile"),), out="out", n_out=n,
                         out_dtype=np.int32, elementwise=True, name="lookup")
    return [dec, cons], env, table[syms]


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_rule4_np_absorbs_elementwise_consumer(backend, rng):
    stages, env, want = rule4_stages(3000, 256, rng)
    (fused,) = fuse(stages)
    assert isinstance(fused, NonParallel)
    assert fused.name == "ans-decode>lookup" and fused.out == "out"
    assert fused.tail == (gather("table"),) and fused.out_dtype == np.int32
    unfused = dict(env)
    for st in stages:
        unfused[st.out] = run_stage(st, unfused, backend)
    got = run_stage(fused, env, backend)
    assert_bitwise(got.numpy(), unfused["out"].numpy(), "fused vs unfused")
    assert_bitwise(got.numpy(), want, "vs source")


def test_rule4_needs_a_single_use_elementwise_consumer(rng):
    stages, _, _ = rule4_stages(500, 256, rng)
    dec, cons = stages
    # the symbols are the final output too: no fusion
    assert len(fuse(stages, final_out="syms")) == 2
    # a consumer that reads another input besides the symbols: no fusion
    two = FullyParallel(chain=cons.chain, inputs=("syms", "table"),
                        specs=(BufSpec("tile"), BufSpec("full")), out="out", n_out=500,
                        name="lookup")
    assert len(fuse([dec, two])) == 2
    # a consumer that is not elementwise: no fusion
    assert len(fuse([dec, dataclasses.replace(cons, elementwise=False)])) == 2


@pytest.mark.parametrize("name", ["L_RETURNFLAG", "O_COMMENT"])
def test_rule4_does_not_fire_on_table2_plans(name):
    from repro_torch.data import columns

    arr = (np.frombuffer(b"A N R N. ", np.uint8) if name == "L_RETURNFLAG"
           else np.frombuffer(b"carefully final deposits. sleep", np.uint8))
    penc = P.encode(columns.TABLE2_PLANS[name], np.tile(arr, 200))
    stages = build_graph(penc).stages
    nps = [st for st in stages if isinstance(st, NonParallel)]
    assert [st.name for st in nps] == ["ans-decode"] and nps[0].tail == ()


def test_non_parallel_wrapper_checks_and_cpu_path(rng):
    arr = rng.integers(0, 9, 700).astype(np.uint8)
    penc = P.encode(P.Plan("ans", params={"chunk_size": 256}), arr)
    env = device_buffers(penc, "cpu")
    (st,) = build_graph(penc).stages
    np.testing.assert_array_equal(non_parallel(st, env).numpy(), arr)
    env_meta = {k: v.to("meta") for k, v in env.items()}
    with pytest.raises(ValueError, match="no Non-Parallel kernel"):
        non_parallel(st, env_meta)
    env[st.sym_tab] = env[st.sym_tab].to("meta")
    with pytest.raises(ValueError, match="span devices"):
        non_parallel(st, env)
