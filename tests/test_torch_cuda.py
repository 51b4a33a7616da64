"""The CUDA kernels on the card against their plain PyTorch versions, bit for bit.

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc`` and skip elsewhere.  On a
machine with a card (no JAX needed there):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.compiler import build_graph, compile_blob, device_buffers
from repro_torch.core.geometry import Geometry
from repro_torch.core.plan import Plan, encode, make_plan
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.loader import ColumnPipeline
from repro_torch.data.tpch import generate
from repro_torch.kernels.fully_parallel import KERNEL as FP, fully_parallel
from repro_torch.kernels.group_parallel import KERNEL as GP, group_parallel

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def decode_both(enc, gpu):
    bufs = device_buffers(enc, gpu)
    before = FP.launches + GP.launches
    got = compile_blob(enc, backend="kernel")(bufs)
    assert FP.launches + GP.launches > before
    plain = compile_blob(enc, backend="torch")(bufs)
    torch.cuda.synchronize()
    return got.cpu(), plain.cpu()


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("bw", [1, 3, 7, 8, 13, 17, 25, 31, 32])
@pytest.mark.parametrize("n", [1, 127, 4097, 1 << 20])
def test_bitpack_kernel_matches_plain(bw, n, gpu):
    rng = np.random.default_rng(bw * 1000 + n)
    lo, hi = (-2**31, 2**31) if bw == 32 else (0, 2**bw)
    arr = rng.integers(lo, hi, n).astype(np.int32)
    got, plain = decode_both(encode(Plan("bitpack", params={"bit_width": bw}), arr), gpu)
    assert torch.equal(got, plain) and torch.equal(got, torch.from_numpy(arr))


@pytest.mark.parametrize("plan", [
    Plan("dictionary", children={"index": make_plan("bitpack")}),
    Plan("float2int", children={"ints": make_plan("bitpack")}),
    Plan("delta", children={"deltas": Plan("dictionary",
                                           children={"index": make_plan("bitpack")})}),
], ids=lambda p: p.describe())
def test_fused_fp_chains_match_plain(plan, gpu):
    rng = np.random.default_rng(1)
    if plan.codec == "float2int":
        arr = (rng.integers(0, 10**7, 300_000) / 100.0).astype(np.float32)
        arr[::1001] = np.float32(0.1234567)                  # exceptions
    else:
        arr = rng.integers(-10**6, 10**6, 300_000).astype(np.int32)
    got, plain = decode_both(encode(plan, arr), gpu)
    assert torch.equal(bits(got), bits(plain))
    assert torch.equal(bits(got), bits(torch.from_numpy(arr)))


@pytest.mark.parametrize("values", ["bitpack", "leaf"])
def test_rle_kernel_on_skewed_runs(values, gpu):
    rng = np.random.default_rng(2)
    counts = np.where(rng.random(50_000) < 0.01, rng.integers(2, 500, 50_000), 1)
    counts[77] = 1_000_000                  # one run far longer than a block
    arr = np.repeat(rng.integers(-2**31, 2**31, counts.size), counts).astype(np.int32)
    kids = {"counts": make_plan("bitpack")}
    if values == "bitpack":
        kids["values"] = make_plan("bitpack")
    got, plain = decode_both(encode(Plan("rle", children=kids), arr), gpu)
    assert torch.equal(got, plain) and torch.equal(got, torch.from_numpy(arr))


def test_pipeline_on_the_card(gpu):
    cols = generate(0.01, seed=0)
    names = ["L_ORDERKEY", "L_SHIPDATE", "O_TOTALPRICE", "PS_SUPPKEY", "O_SHIPPRIORITY"]
    pipe = ColumnPipeline({k: TABLE2_PLANS[k] for k in names})
    assert pipe.backend == "kernel" and pipe.device.type == "cuda"
    pipe.compress({k: cols[k] for k in names})
    FP.launches = GP.launches = 0
    res = pipe.run()
    assert FP.launches > 0 and GP.launches > 0
    for k in names:
        assert torch.equal(bits(res[k].array.cpu()), bits(torch.from_numpy(cols[k])))
        assert res[k].kernel_launches >= 1
    assert pipe.makespan_s > 0


def test_launch_rejects_mixed_devices(gpu):
    enc = encode(make_plan("bitpack"), np.arange(100, dtype=np.int32))
    (st,) = build_graph(enc).stages
    bufs = device_buffers(enc, gpu)
    bufs[st.inputs[1]] = bufs[st.inputs[1]].cpu()
    with pytest.raises(ValueError):
        fully_parallel(st, bufs)


@pytest.mark.parametrize("geom", [Geometry(1, 32, 1), Geometry(2, 64, 3),
                                  Geometry(4, 256, 1), Geometry(1, 1024, 4)], ids=str)
def test_kernels_at_other_geometries(geom, gpu):
    """The <L,S,C> loop covers every element exactly once at any geometry."""
    rng = np.random.default_rng(3)
    counts = rng.integers(1, 30, 20_000)
    arr = np.repeat(rng.integers(0, 5000, counts.size), counts).astype(np.int32)
    enc = encode(Plan("rle", children={"counts": make_plan("bitpack"),
                                       "values": make_plan("bitpack")}), arr)
    env = device_buffers(enc, gpu)
    presum, gp = build_graph(enc).stages
    env[presum.out] = presum.fn(fully_parallel(presum.producers[0], env, geom))
    got = group_parallel(gp, env, geom)
    assert torch.equal(got.cpu(), torch.from_numpy(arr))
    fp_enc = encode(make_plan("bitpack"), arr)
    (fp,) = build_graph(fp_enc).stages
    got = fully_parallel(fp, device_buffers(fp_enc, gpu), geom)
    assert torch.equal(got.cpu(), torch.from_numpy(arr))
