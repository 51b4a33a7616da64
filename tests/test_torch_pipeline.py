"""The slice as a whole: TPC-H (scale 0.002) through the port's ``ColumnPipeline``
on the CPU, against the source columns and the JAX reference's Pallas decode.

The port's pipeline runs once per module (all 24 Table-2 columns, whole-column
FIFO streaming);
each column is then held bit for bit against its source array and against the
reference's ``compile_decoder(backend="pallas", interpret=True)`` output on the
same blob.
"""
import numpy as np
import pytest
import torch

from repro.core import plan as RP
from repro.core.compiler import compile_decoder, device_buffers as ref_device_buffers
from repro.core.geometry import Geometry

from repro_torch.core import plan as P
from repro_torch.core.executor import ColumnExec, StreamingExecutor
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.loader import ColumnPipeline
from repro_torch.data.tpch import generate

GEOMS = {"fp": Geometry(2, 8, 512), "gp": Geometry(2, 8, 512),
         "np": Geometry(1, 8, 512)}
COLUMNS = tuple(TABLE2_PLANS)


def as_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.fixture(scope="module")
def cols():
    return {k: v for k, v in generate(0.002, seed=0).items() if k in TABLE2_PLANS}


@pytest.fixture(scope="module")
def pipe_run(cols):
    # FIFO whole-column streaming, one copy per column, no batching (the
    # planner's defaults are covered in test_torch_planner.py)
    pipe = ColumnPipeline(dict(TABLE2_PLANS), device="cpu", policy="fifo",
                          chunk_bytes=None, batch_columns=False)
    ratios = pipe.compress(cols)
    return pipe, ratios, pipe.run()


@pytest.mark.parametrize("name", COLUMNS)
def test_column_matches_source_and_reference(name, cols, pipe_run):
    pipe, ratios, res = pipe_run
    rec = res[name]
    got = rec.array.numpy()
    assert got.dtype == cols[name].dtype and got.shape == cols[name].shape
    np.testing.assert_array_equal(as_bits(got), as_bits(cols[name]))
    # the reference decodes the very blob the port decoded
    enc = pipe.encoded(name)
    renc = _ref_tree(enc)
    want = compile_decoder(renc, backend="pallas", geometry=GEOMS,
                           interpret=True)(ref_device_buffers(renc))
    np.testing.assert_array_equal(as_bits(got), as_bits(want))
    assert rec.compressed_bytes == enc.compressed_nbytes
    assert rec.plain_bytes == cols[name].nbytes
    assert ratios[name] == pytest.approx(enc.ratio)
    assert rec.kernel_launches == 0          # CPU: plain versions, no CUDA kernel


def _ref_tree(enc: P.Encoded) -> RP.Encoded:
    return RP.Encoded(codec=enc.codec, meta=dict(enc.meta), buffers=dict(enc.buffers),
                      children={k: _ref_tree(c) for k, c in enc.children.items()},
                      n=enc.n, dtype=enc.dtype)


def test_pipeline_run_records(cols, pipe_run):
    pipe, _, res = pipe_run
    assert list(res) == list(cols)          # registration order is the FIFO order
    assert pipe.backend == "torch" and pipe.device.type == "cpu"
    assert pipe.makespan_s is not None and pipe.makespan_s > 0
    for rec in res.values():
        assert isinstance(rec, ColumnExec)
        assert rec.transfer_s >= 0 and rec.decode_s >= 0 and rec.n_chunks == 1
    stats = pipe.cache_stats
    # 24 columns, some share a structure: fewer programs than columns
    assert stats["programs"] == stats["misses"] and stats["hits"] >= 1
    assert stats["programs"] + stats["hits"] == len(COLUMNS)


@pytest.mark.parametrize("name", ["L_RETURNFLAG", "O_COMMENT"])
def test_narrow_leaves_stage_at_their_own_width(name, pipe_run):
    """uint8 and uint16 leaves are staged as they are, not widened: the staged
    operands hold the blob's compressed bytes plus the lifted (1,) meta."""
    pipe, _, res = pipe_run
    enc = pipe.encoded(name)
    layout = {k: (nb, dt) for k, _, nb, dt, _ in pipe.executor._staged[name].layout}
    leaves = P.flat_buffers(enc)
    for k, a in leaves.items():
        assert layout[k] == (a.nbytes, {np.dtype(np.uint32): torch.int32}.get(
            a.dtype, torch.from_numpy(a[:0]).dtype)), k
    assert {a.dtype for a in leaves.values()} >= {np.dtype(np.uint8),
                                                  np.dtype(np.uint16)}
    meta = sum(nb for k, (nb, _) in layout.items() if k not in leaves)
    assert sum(nb for nb, _ in layout.values()) - meta == enc.compressed_nbytes
    assert res[name].compressed_bytes == enc.compressed_nbytes


def test_explicit_order_and_window(cols):
    names = ["O_ORDERKEY", "L_TAX", "PS_SUPPKEY"]
    pipe = ColumnPipeline({k: TABLE2_PLANS[k] for k in names}, device="cpu")
    pipe.compress({k: cols[k] for k in names})
    res = pipe.run(order=names[::-1], window=3)
    assert list(res) == names[::-1]
    for k in names:
        np.testing.assert_array_equal(as_bits(res[k].array.numpy()), as_bits(cols[k]))
    with pytest.raises(KeyError):
        pipe.run(order=["L_SHIPDATE"])
    with pytest.raises(ValueError):
        pipe.run(window=0)


def test_kernel_backend_on_cpu_tensors_uses_plain_versions(cols):
    names = ["L_SHIPDATE", "O_SHIPPRIORITY", "L_ORDERKEY"]
    pipe = ColumnPipeline({k: TABLE2_PLANS[k] for k in names}, device="cpu",
                          backend="kernel")
    pipe.compress({k: cols[k] for k in names})
    res = pipe.run()
    for k in names:
        np.testing.assert_array_equal(res[k].array.numpy(), cols[k])


def test_executor_shares_programs_across_same_structure(cols):
    ex = StreamingExecutor(backend="torch", device="cpu")
    a = ex.compile("a", P.encode(TABLE2_PLANS["L_DISCOUNT"], cols["L_DISCOUNT"]))
    b = ex.compile("b", P.encode(TABLE2_PLANS["L_TAX"], cols["L_TAX"]))
    assert a is b and ex.cache.stats == {"programs": 1, "hits": 1, "misses": 1,
                                         "evictions": 0}
    out = ex.run()
    assert torch.equal(out["b"].array, torch.from_numpy(cols["L_TAX"]))
