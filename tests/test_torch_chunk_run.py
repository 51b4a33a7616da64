"""The port's chunked and group-span streaming end to end on the CPU, against
the JAX reference's chunked ``StreamingExecutor.run`` on the same blobs.

For the 24 Table-2 columns at scale 0.002 and the synthetic RLE, DeltaStride
and rANS columns, at 256 B, 4 KiB, 64 KiB and 1 MiB with ``chunk_decode=True``:
each column's output is bitwise equal to the port's whole-column output, to the
reference's chunked output and to the source; ``n_chunks`` and
``decode_launches`` equal the reference's; and the chunk and span programs are
shared per structure as the reference shares them.
"""
import numpy as np
import pytest
import torch

from repro.core import plan as RP
from repro.core.compiler import ProgramCache as RefCache
from repro.core.executor import StreamingExecutor as RefExecutor
from repro.data.columns import TABLE2_PLANS as REF_PLANS

from repro_torch.core import plan as P
from repro_torch.core.executor import StreamingExecutor
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.loader import ColumnPipeline
from repro_torch.data.tpch import generate

COLUMNS = tuple(TABLE2_PLANS)
SIZES = (256, 4096, 1 << 16, 1 << 20)
STREAMED = ("chunk", "gchunk", "gprologue")


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def synthetic() -> dict[str, RP.Encoded]:
    rng = np.random.default_rng(0)
    rle = np.repeat(rng.integers(0, 50, 501), rng.integers(1, 120, 501)).astype(np.int32)
    mono = np.arange(80_000, dtype=np.int32)
    mono[17::97] += 3
    ans = RP.Plan("ans", params={"chunk_size": 512})
    return {"rle": RP.encode(RP.make_plan("rle"), rle),
            "deltastride": RP.encode(RP.make_plan("deltastride"), mono),
            "ans-int32": RP.encode(ans, rng.integers(0, 40, 30_000).astype(np.int32)),
            "ans-uint8": RP.encode(ans, rng.integers(0, 40, 3_001).astype(np.uint8))}


def run_both(encs: dict[str, RP.Encoded], chunk_bytes: int) -> dict:
    """Reference and port, chunked at ``chunk_bytes``, plus the port whole."""
    rex = RefExecutor(chunk_bytes=chunk_bytes, chunk_decode=True, cache=RefCache(),
                      policy="fifo")
    want = rex.run(encs)
    ex = StreamingExecutor("torch", "cpu", chunk_bytes=chunk_bytes, chunk_decode=True)
    whole = StreamingExecutor("torch", "cpu")
    for k, renc in encs.items():
        ex.compile(k, P.encoded_from_reference(renc))
        whole.compile(k, P.encoded_from_reference(renc))
    return {"ref": want, "got": ex.run(), "whole": whole.run(),
            "ref_keys": set(rex.cache._programs), "keys": set(ex.cache._programs),
            "ex": ex}


@pytest.fixture(scope="module")
def cols():
    return {k: v for k, v in generate(0.002, seed=0).items() if k in TABLE2_PLANS}


@pytest.fixture(scope="module")
def table2_runs(cols):
    encs = {k: RP.encode(REF_PLANS[k], cols[k]) for k in COLUMNS}
    return {cb: run_both(encs, cb) for cb in SIZES}


@pytest.fixture(scope="module")
def synthetic_runs():
    encs = synthetic()
    return encs, {cb: run_both(encs, cb) for cb in SIZES}


def check_column(runs: dict, name: str, source: np.ndarray) -> None:
    got, want, whole = runs["got"][name], runs["ref"][name], runs["whole"][name]
    a = got.array.numpy()
    assert a.dtype == source.dtype and a.shape == source.shape
    np.testing.assert_array_equal(bits(a), bits(source))
    np.testing.assert_array_equal(bits(a), bits(whole.array.numpy()))
    np.testing.assert_array_equal(bits(a), bits(want.array))
    assert got.decode_launches == want.decode_launches
    assert got.n_chunks == want.n_chunks
    assert got.chunk_decoded == want.chunk_decoded
    assert got.kernel_launches == 0       # CPU: the plain versions


@pytest.mark.parametrize("chunk_bytes", SIZES)
@pytest.mark.parametrize("name", COLUMNS)
def test_table2_chunked_output_matches_reference(name, chunk_bytes, cols, table2_runs):
    check_column(table2_runs[chunk_bytes], name, cols[name])


@pytest.mark.parametrize("chunk_bytes", SIZES)
@pytest.mark.parametrize("name", ("rle", "deltastride", "ans-int32", "ans-uint8"))
def test_synthetic_chunked_output_matches_reference(name, chunk_bytes, synthetic_runs):
    encs, runs = synthetic_runs
    check_column(runs[chunk_bytes], name, RP.decode_np(encs[name]))
    if chunk_bytes == 256:
        rec = runs[chunk_bytes]["got"][name]
        assert rec.chunk_decoded and rec.decode_launches > 2


@pytest.mark.parametrize("chunk_bytes", SIZES)
def test_table2_decode_units_per_run(chunk_bytes, table2_runs):
    runs = table2_runs[chunk_bytes]
    units = sum(r.decode_launches for r in runs["got"].values())
    assert units == sum(r.decode_launches for r in runs["ref"].values())
    assert units > len(COLUMNS) if chunk_bytes <= 4096 else units == len(COLUMNS)


@pytest.mark.parametrize("chunk_bytes", SIZES)
def test_streamed_programs_shared_as_in_reference(chunk_bytes, table2_runs,
                                                  synthetic_runs):
    """One chunk program per (structure, chunk size), one span program per
    (structure, groups, padded shape), one prologue per structure: the same
    keys, backend aside, as the reference's cache holds."""
    kinds = set()
    for runs in (table2_runs[chunk_bytes], synthetic_runs[1][chunk_bytes]):
        want = {k[:-1] for k in runs["ref_keys"] if k[1] in STREAMED}
        got = {k[:-1] for k in runs["keys"] if k[1] in STREAMED}
        assert got == want
        kinds |= {k[1] for k in got}
    if chunk_bytes == 256:
        assert kinds == set(STREAMED)


def test_chunked_transfer_with_whole_decode(cols):
    """``chunk_bytes`` without ``chunk_decode``: every leaf moves in pieces of
    at most ``chunk_bytes`` and the column decodes whole (the reference's
    default mode), with the reference's transfer-piece count."""
    names = ("L_EXTENDEDPRICE", "O_COMMENT", "L_RETURNFLAG", "PS_SUPPKEY")
    pipe = ColumnPipeline({k: TABLE2_PLANS[k] for k in names}, device="cpu",
                          chunk_bytes=1024)
    pipe.compress({k: cols[k] for k in names})
    rex = RefExecutor(chunk_bytes=1024, cache=RefCache())
    for k in names:
        rex.compile(k, RP.encode(REF_PLANS[k], cols[k]))
    res = pipe.run()
    for k in names:
        staged = pipe.executor._staged[k]
        assert all(b - a <= 1024 for a, b in staged.copies)
        # one copy per non-empty piece, the (1,) meta operands in one
        assert res[k].n_chunks == rex._n_chunks(k, 1024) >= len(staged.copies) - 1 > 2
        assert res[k].decode_launches == 1 and not res[k].chunk_decoded
        np.testing.assert_array_equal(bits(res[k].array.numpy()), bits(cols[k]))


def test_pipeline_chunk_options_and_order(cols):
    """``ColumnPipeline`` takes the reference's ``chunk_bytes`` and
    ``chunk_decode``; an explicit order and window apply to decode units."""
    names = ["L_RETURNFLAG", "L_PARTKEY", "O_ORDERKEY"]
    pipe = ColumnPipeline({k: TABLE2_PLANS[k] for k in names}, device="cpu",
                          chunk_bytes=256, chunk_decode=True)
    pipe.compress({k: cols[k] for k in names})
    assert pipe.executor.chunk_bytes == 256 and pipe.executor.chunk_decode
    for window in (1, 3, 100):
        res = pipe.run(order=names[::-1], window=window)
        assert list(res) == names[::-1]
        for k in names:
            np.testing.assert_array_equal(res[k].array.numpy(), cols[k])
    assert res["L_PARTKEY"].decode_launches > 10
    assert res["L_RETURNFLAG"].chunk_decoded and not res["O_ORDERKEY"].chunk_decoded


def test_kernel_backend_on_cpu_tensors_chunked(cols):
    """The kernel backend's chunk and span entries take the plain versions for
    CPU tensors, writing each range of the output in place."""
    names = ["L_SHIPDATE", "L_RETURNFLAG"]
    pipe = ColumnPipeline({k: TABLE2_PLANS[k] for k in names}, device="cpu",
                          backend="kernel", chunk_bytes=256, chunk_decode=True)
    pipe.compress({k: cols[k] for k in names})
    res = pipe.run()
    for k in names:
        assert res[k].chunk_decoded
        np.testing.assert_array_equal(res[k].array.numpy(), cols[k])


def test_recompile_replaces_the_schedule(cols):
    ex = StreamingExecutor("torch", "cpu", chunk_bytes=256, chunk_decode=True)
    ex.compile("c", P.encode(TABLE2_PLANS["L_PARTKEY"], cols["L_PARTKEY"]))
    first = ex.chunk_schedule("c")
    ex.compile("c", P.encode(TABLE2_PLANS["L_PARTKEY"], cols["L_PARTKEY"][:1000]))
    assert ex.chunk_schedule("c") is not first
    assert torch.equal(ex.run()["c"].array, torch.from_numpy(cols["L_PARTKEY"][:1000]))


def test_same_structure_columns_use_their_own_group_offsets():
    """Two RLE columns of one structure (equal signatures) whose runs differ:
    they share the span programs, and each is split on its own group offsets.
    (The reference's executor takes the schedule from the shared program's
    graph, so its second column decodes wrong here; the port keeps each
    column's own graph.)"""
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 50, 500)
    counts = rng.integers(1, 120, 500)
    a = np.repeat(vals, counts).astype(np.int32)
    b = np.repeat(vals, counts[::-1]).astype(np.int32)
    ex = StreamingExecutor("torch", "cpu", chunk_bytes=256, chunk_decode=True)
    ex.compile("a", P.encode(P.make_plan("rle"), a))
    ex.compile("b", P.encode(P.make_plan("rle"), b))
    assert ex.graph("a").signature == ex.graph("b").signature
    assert ex.chunk_schedule("a").out_starts != ex.chunk_schedule("b").out_starts
    res = ex.run()
    np.testing.assert_array_equal(res["a"].array.numpy(), a)
    np.testing.assert_array_equal(res["b"].array.numpy(), b)
    spans = [k for k in ex.cache._programs if k[1] == "gchunk"]
    assert len(spans) <= 2 * 2          # body + tail per column at most, shared
