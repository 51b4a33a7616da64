"""The CUDA kernels on the card against their plain PyTorch versions, bit for bit.

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc`` and skip elsewhere.  On a
machine with a card (no JAX needed there):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import functools
import itertools
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.compiler import build_graph, compile_blob, device_buffers
from repro_torch.core.fusion import fuse
from repro_torch.core.geometry import Geometry
from repro_torch.core.geometry import native_config
from repro_torch.algos.bitpack import pack_np
from repro_torch.core.patterns import (AFFINE, IDENTITY, STRGATHER, BufSpec,
                                       FullyParallel, GroupParallel, gather, load,
                                       load_bytes, span, unpack, unzigzag)
from repro_torch.core.executor import StreamingExecutor
from repro_torch.core.plan import Plan, encode, host_operands, make_plan
from repro_torch.core.query import Bin, Col, Const, Pred, QueryPlan
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.loader import ColumnPipeline
from repro_torch.data.tpch import generate
from repro_torch.kernels import ref
from repro_torch.kernels.fully_parallel import KERNEL as FP, fully_parallel
from repro_torch.kernels.group_parallel import KERNEL as GP, group_parallel, tile_windows
from repro_torch.kernels.non_parallel import KERNEL as NP, decode_table, non_parallel

pytestmark = pytest.mark.cuda


def _launches() -> int:
    return FP.launches + GP.launches + NP.launches


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def decode_both(enc, gpu):
    bufs = device_buffers(enc, gpu)
    before = _launches()
    got = compile_blob(enc, backend="kernel")(bufs)
    assert _launches() > before
    plain = compile_blob(enc, backend="torch")(bufs)
    torch.cuda.synchronize()
    return got.cpu(), plain.cpu()


def bits(t):
    """A 4-byte tensor as int32 bits (torch compares few uint32 ops)."""
    return t.view(torch.int32) if t.dtype in (torch.float32, torch.uint32) else t


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
    names = ["L_ORDERKEY", "L_SHIPDATE", "O_TOTALPRICE", "PS_SUPPKEY", "O_SHIPPRIORITY",
             "L_RETURNFLAG", "O_COMMENT"]
    pipe = ColumnPipeline({k: TABLE2_PLANS[k] for k in names})
    assert pipe.backend == "kernel" and pipe.device.type == "cuda"
    pipe.compress({k: cols[k] for k in names})
    FP.launches = GP.launches = NP.launches = 0
    res = pipe.run()
    assert FP.launches > 0 and GP.launches > 0 and NP.launches > 0
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


# ------------------------------------------------------- kernel 3 and byte widths

def ans_sweep_input(kind: str, n: int, rng) -> np.ndarray:
    if kind == "skewed":
        return np.where(rng.random(n) < 0.995, 78, rng.integers(0, 256, n)) \
            .astype(np.uint8)
    if kind == "one-symbol":
        return np.full(n, 82, np.uint8)
    if kind == "float32":
        return rng.normal(0, 1e3, n).astype(np.float32)
    if kind == "int32":
        return rng.integers(-2**31, 2**31, n).astype(np.int32)
    if kind == "uniform256":
        return rng.integers(0, 256, n).astype(np.uint8)
    return rng.integers(0, 5, n).astype(np.uint8)


@pytest.mark.parametrize("chunk", [256, 1000, 4096])
@pytest.mark.parametrize("kind", ["uint8", "int32", "float32", "skewed", "one-symbol",
                                  "uniform256"])
@pytest.mark.parametrize("n", [1, 4096 * 3, 1_000_003])
def test_ans_kernel_matches_plain(kind, chunk, n, gpu):
    """Kernel 3 (and kernel 1's BYTES source for wider items) against the plain
    versions, and the source, bit for bit; n = 1_000_003 is not a multiple of
    any chunk size, and 1000 is not a multiple of a 16-byte store."""
    arr = ans_sweep_input(kind, n, np.random.default_rng(n + chunk))
    enc = encode(Plan("ans", params={"chunk_size": chunk}), arr)
    before = NP.launches
    got, plain = decode_both(enc, gpu)
    assert NP.launches == before + 1
    assert torch.equal(bits(got), bits(plain))
    assert torch.equal(bits(got), bits(torch.from_numpy(arr)))


@pytest.mark.parametrize("geom", [Geometry(1, 32, 1), Geometry(2, 64, 3),
                                  Geometry(1, 1024, 1)], ids=str)
def test_ans_kernel_at_other_geometries(geom, gpu):
    arr = np.random.default_rng(4).integers(0, 30, 300_001).astype(np.uint8)
    enc = encode(Plan("ans", params={"chunk_size": 256}), arr)
    (st,) = build_graph(enc).stages
    got = non_parallel(st, device_buffers(enc, gpu), geom)
    assert torch.equal(got.cpu(), torch.from_numpy(arr))


def test_ans_kernel_with_a_fused_tail(gpu):
    """Fusion rule 4: each symbol goes through the tail (here a GATHER into an
    int32 table) inside kernel 3, which then writes 4-byte elements."""
    rng = np.random.default_rng(5)
    syms = rng.integers(0, 40, 500_000).astype(np.uint8)
    enc = encode(Plan("ans", params={"chunk_size": 4096}), syms)
    env = device_buffers(enc, gpu)
    table = rng.integers(-2**31, 2**31, 40).astype(np.int32)
    env["table"] = torch.from_numpy(table).to(gpu)
    (dec,) = build_graph(enc).stages
    dec.out = "syms"
    cons = FullyParallel(chain=(load("syms"), gather("table")), inputs=("syms",),
                         specs=(BufSpec("tile"),), out="out", n_out=syms.size,
                         name="lookup")
    (fused,) = fuse([dec, cons])
    got = non_parallel(fused, env)
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.non_parallel_torch(fused, env))
    assert torch.equal(got.cpu(), torch.from_numpy(table[syms]))


def comment_bytes(n_rows: int, rng, end_with_delimiter: bool) -> np.ndarray:
    words = np.array(["furiously", "quickly", "regular", "deposits", "sleep", "the",
                      "carefully", "final", "packages", "ironic", "accounts"])
    text = "".join(" ".join(rng.choice(words, int(rng.integers(3, 12))))
                   + str(rng.choice([". ", " ", "."])) for _ in range(n_rows))
    if not end_with_delimiter:
        text = text.rstrip(". ") + " trailing"
    return np.frombuffer(text.encode(), np.uint8).copy()


@pytest.mark.parametrize("end_with_delimiter", [True, False])
@pytest.mark.parametrize("index", ["leaf", "bitpack", "bitpack[ans]"])
def test_stringdict_gp_writes_bytes(index, end_with_delimiter, gpu):
    """Kernel 2's STRGATHER map over (chars, offsets) with a uint8 output."""
    arr = comment_bytes(20_000, np.random.default_rng(6), end_with_delimiter)
    kids = {"leaf": {}, "bitpack": {"index": make_plan("bitpack")},
            "bitpack[ans]": {"index": Plan("bitpack",
                                           children={"packed": make_plan("ans")})}}
    enc = encode(Plan("stringdict", children=kids[index]), arr)
    before = GP.launches
    got, plain = decode_both(enc, gpu)
    assert GP.launches == before + 1
    assert got.dtype == torch.uint8
    assert torch.equal(got, plain) and torch.equal(got, torch.from_numpy(arr))


def _guarded(n: int, gpu):
    """A freed block of n bytes followed by a guard block: a kernel output of n
    uint8 allocated next reuses the hole, so an overrun lands in the guard."""
    hole = torch.empty(n, dtype=torch.uint8, device=gpu)
    guard = torch.full((1 << 20,), 0x5A, dtype=torch.uint8, device=gpu)
    del hole
    return guard


def test_uint8_gather_output_does_not_overrun(gpu):
    rng = np.random.default_rng(7)
    n = 100_000
    env = {"i": torch.from_numpy(rng.integers(0, 200, n).astype(np.int32)).to(gpu),
           "t": torch.from_numpy(rng.integers(0, 256, 200).astype(np.uint8)).to(gpu)}
    st = FullyParallel(chain=(load("i"), gather("t")), inputs=("i", "t"),
                       specs=(BufSpec("tile"), BufSpec("full")), out="o", n_out=n,
                       out_dtype=np.uint8, name="lookup")
    guard = _guarded(n, gpu)
    got = fully_parallel(st, env)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8
    assert torch.equal(got, ref.fully_parallel_torch(st, env))
    assert bool((guard == 0x5A).all())


def test_bytes_source_of_the_fp_kernel(gpu):
    """BYTES at item sizes 2, 4 and 8 (int16, uint32/float32 bitcast, int64's
    low word), against the plain version."""
    rng = np.random.default_rng(8)
    raw = torch.from_numpy(rng.integers(0, 256, 8 * 70_001).astype(np.uint8)).to(gpu)
    for itemsize, out_dtype in ((2, np.int16), (4, np.uint32), (4, np.float32),
                                (8, np.int32)):
        n = raw.numel() // itemsize
        st = FullyParallel(chain=(load_bytes("b", itemsize),), inputs=("b",),
                           specs=(BufSpec("tile", num=itemsize),), out="o", n_out=n,
                           out_dtype=out_dtype, elementwise=False,
                           name="byte-reassemble")
        env = {"b": raw}
        got = fully_parallel(st, env)
        assert got.dtype == ref.torch_dtype(out_dtype)
        assert torch.equal(bits(got), bits(ref.fully_parallel_torch(st, env)))
        want = raw.cpu().numpy().view({2: np.int16, 4: np.uint32, 8: np.int64}[itemsize])
        want = want.view(out_dtype) if itemsize == 4 else want.astype(out_dtype)
        assert np.array_equal(bits(got.cpu()).numpy(), bits(torch.from_numpy(want)).numpy())


# ------------------------------------------------ kernel 2's windows, kernel 3's tables

def _gp_counts(case: str, rng) -> np.ndarray:
    tile = native_config("gp").S * native_config("gp").C
    if case == "zero-counts":
        counts = rng.integers(1, 4, 300_000)
        counts[rng.random(counts.size) < 0.3] = 0
        counts[100_000:180_000] = 0
        return counts
    if case == "all-ones":
        return np.ones(500_003, np.int64)
    return np.concatenate([rng.integers(1, 5, 2000), [40 * tile], rng.integers(1, 5, 2000)])


@pytest.mark.parametrize("map_kind", [IDENTITY, AFFINE, STRGATHER])
@pytest.mark.parametrize("case", ["zero-counts", "all-ones", "long-run"])
def test_gp_windows(case, map_kind, gpu):
    """Zero-count groups overflow a block's shared window (the kernel's global
    path); all counts 1 fill a window exactly; one run spans many tiles; each
    through the three maps."""
    rng = np.random.default_rng(9)
    counts = _gp_counts(case, rng)
    presum = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    names = {IDENTITY: ("vals",), AFFINE: ("vals", "strides"),
             STRGATHER: ("words",)}[map_kind]
    env = {"presum": torch.from_numpy(presum).to(gpu)}
    for k in ("vals", "strides"):
        env[k] = torch.from_numpy(rng.integers(-2**31, 2**31, counts.size)
                                  .astype(np.int32)).to(gpu)
    env["words"] = torch.from_numpy(rng.integers(0, 1000, counts.size)
                                    .astype(np.int32)).to(gpu)
    env["chars"] = torch.from_numpy(rng.integers(0, 256, 50_000).astype(np.uint8)).to(gpu)
    env["offs"] = torch.from_numpy(np.sort(rng.integers(0, 49_000, 1001))
                                   .astype(np.int32)).to(gpu)
    tile = native_config("gp").S * native_config("gp").C
    windows = tile_windows(env["presum"], int(presum[-1]), tile)
    assert {"zero-counts": int(windows.max()) > tile, "all-ones": int(windows.max()) == tile,
            "long-run": int((windows == 1).sum()) >= 38}[case]
    st = GroupParallel(presum="presum", value_inputs=names,
                       value_specs=(BufSpec("tile"),) * len(names),
                       values=tuple((load(k),) for k in names), map_kind=map_kind,
                       extra_inputs=("chars", "offs") if map_kind == STRGATHER else (),
                       out_dtype=np.uint8 if map_kind == STRGATHER else np.int32,
                       out="out", n_out=int(presum[-1]), n_groups=counts.size, name=case)
    before = GP.launches
    got = group_parallel(st, env)
    assert GP.launches == before + 1
    assert torch.equal(got, ref.group_parallel_torch(st, env))
    if map_kind == IDENTITY:
        want = np.repeat(env["vals"].cpu().numpy(), counts)
        assert torch.equal(got.cpu(), torch.from_numpy(want))


def test_stringdict_words_longer_than_a_thread(gpu):
    rng = np.random.default_rng(10)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    lens = rng.integers(17, 65, 50_000)
    text = rng.choice(letters, int(lens.sum()) + lens.size)
    text[np.cumsum(lens + 1) - 1] = ord(" ")
    text = text.astype(np.uint8)
    got, plain = decode_both(encode(make_plan("stringdict"), text), gpu)
    assert torch.equal(got, plain) and torch.equal(got, torch.from_numpy(text))


def test_ans_three_table_path(gpu):
    """Tables outside the packed layout decode as the plain version does."""
    arr = np.random.default_rng(11).integers(0, 5, 100_003).astype(np.uint8)
    enc = encode(Plan("ans", params={"chunk_size": 1000}), arr)
    env = device_buffers(enc, gpu)
    (st,) = build_graph(enc).stages
    cum = env[st.cum_tab].to(torch.int32).cpu().numpy()
    cum[int(np.argmax(env[st.freq_tab].to(torch.int32).cpu().numpy() > 3))] += 3
    env[st.cum_tab] = torch.from_numpy(cum.astype(np.uint16)).to(gpu)
    assert not decode_table(env[st.sym_tab], env[st.freq_tab], env[st.cum_tab])[1]
    assert torch.equal(non_parallel(st, env), ref.non_parallel_torch(st, env))


# ------------------------------------------------ kernel 1's staged and wide paths

def _fp(chain, inputs, n, out_dtype=np.int32):
    return FullyParallel(chain=chain, inputs=inputs,
                         specs=tuple(BufSpec("full") for _ in inputs), out="o", n_out=n,
                         out_dtype=out_dtype, elementwise=False, name="case")


def _packed(bw: int, n: int, rng, gpu, cut: int = 0, offset: int = 0):
    """Bit-packed uniform values of ``bw`` bits (the encoder's layout, guard word
    included) with ``cut`` words dropped from the end and the buffer starting
    ``offset`` words into its allocation; returns the env and the values."""
    vals = rng.integers(0, 1 << bw, n, dtype=np.int64) if bw else np.zeros(n, np.int64)
    words = pack_np(vals, bw) if bw else np.zeros(2, np.uint32)
    words = words[:max(1, words.size - cut)].view(np.int32)
    buf = torch.from_numpy(np.concatenate([np.zeros(offset, np.int32), words])).to(gpu)
    base = int(rng.integers(-2**31, 2**31))
    env = {"p": buf[offset:], "bw": torch.tensor([bw], dtype=torch.int32, device=gpu),
           "base": torch.tensor([base], dtype=torch.int32, device=gpu)}
    return env, (vals + base + 2**31) % 2**32 - 2**31


UNPACK_OP = (unpack("p", "bw", "base"),)
FP_TILE = native_config("fp").tile


def _fp_check(st, env, geom=None):
    before = FP.launches
    got = fully_parallel(st, env, geom)
    assert FP.launches == before + 1
    want = ref.fully_parallel_torch(st, env)
    assert got.dtype == want.dtype and torch.equal(bits(got), bits(want))
    return got


@pytest.mark.parametrize("bw", range(33))
def test_fp_unpack_every_bit_width(bw, gpu):
    """Every bit width 0-32 at lengths around a warp, a 16-byte group and a
    block's tile: the staged path against the plain version and the source."""
    rng = np.random.default_rng(bw)
    for n in (1, 31, 32, 127, 128, FP_TILE - 1, FP_TILE, FP_TILE + 1, 1_000_003):
        env, want = _packed(bw, n, rng, gpu)
        got = _fp_check(_fp(UNPACK_OP, ("p", "bw", "base"), n), env)
        assert np.array_equal(got.cpu().numpy().astype(np.int64), want)


@pytest.mark.parametrize("bw", [1, 7, 13, 31, 32])
def test_fp_unpack_clamps_a_short_buffer(bw, gpu):
    """No guard word, or words missing past it, at every 16-byte misalignment
    of the buffer: reads past the last word take the last word, as the plain
    version's clamp does."""
    rng = np.random.default_rng(100 + bw)
    for n, cut, offset in itertools.product((127, FP_TILE + 1, 2 * FP_TILE + 5),
                                            (1, 2, 9, 10**9), range(4)):
        env, _ = _packed(bw, n, rng, gpu, cut=cut, offset=offset)
        _fp_check(_fp(UNPACK_OP, ("p", "bw", "base"), n), env)


@pytest.mark.parametrize("bw", [33, 40, 64, 100])
def test_fp_unpack_bit_width_outside_the_encoders(bw, gpu):
    """A bit-width operand above 32 takes the kernel's per-element global path."""
    env, _ = _packed(31, 300_001, np.random.default_rng(bw), gpu)
    env["bw"] = torch.tensor([bw], dtype=torch.int32, device=gpu)
    _fp_check(_fp(UNPACK_OP, ("p", "bw", "base"), 300_001), env)


@pytest.mark.parametrize("geom", [Geometry(3, 96, 5), Geometry(32, 256, 4)], ids=str)
def test_fp_unpack_at_tiles_off_the_native_one(geom, gpu):
    """A tile that is not a multiple of 128 (blocks start mid-word) and one
    whose window at wide bit widths overflows the staging buffer."""
    rng = np.random.default_rng(12)
    for bw in (0, 3, 17, 32):
        env, _ = _packed(bw, 3 * geom.tile + 13, rng, gpu)
        _fp_check(_fp(UNPACK_OP, ("p", "bw", "base"), 3 * geom.tile + 13), env, geom)


@pytest.mark.parametrize("source", ["unpack", "load"])
@pytest.mark.parametrize("table", [np.uint8, np.uint16])
def test_fp_narrow_gathers(source, table, gpu):
    """GATHER of uint8 and uint16 tables: 1- and 2-byte outputs, 16 and 8 per
    thread."""
    rng = np.random.default_rng(13)
    n = 1_000_003
    env, _ = _packed(9, n, rng, gpu)
    env["x"] = torch.from_numpy(rng.integers(-5, 600, n).astype(np.int16)).to(gpu)
    top = np.iinfo(table).max + 1
    env["t"] = torch.from_numpy(rng.integers(0, top, 513).astype(table)).to(gpu)
    chain = (UNPACK_OP if source == "unpack" else (load("x"),)) + (gather("t"),)
    ins = ("p", "bw", "base", "t") if source == "unpack" else ("x", "t")
    got = _fp_check(_fp(chain, ins, n, table), env)
    assert got.dtype == ref.torch_dtype(table)


@pytest.mark.parametrize("itemsize", [1, 2, 3, 4, 5])
def test_fp_bytes_item_sizes(itemsize, gpu):
    """BYTES items of 1-5 bytes, from an aligned buffer and from one that starts
    1-3 bytes past a word (the aligned-word path and its ragged edges)."""
    rng = np.random.default_rng(14)
    raw = torch.from_numpy(rng.integers(0, 256, 5 * 300_007 + 8).astype(np.uint8)).to(gpu)
    for offset, n in itertools.product(range(4), (1, 31, 300_007)):
        b = raw[offset:offset + n * itemsize]
        for out_dtype in ((np.int32, np.uint32, np.float32) if itemsize == 4 else (np.int32,)):
            _fp_check(_fp((load_bytes("b", itemsize),), ("b",), n, out_dtype), {"b": b})


def test_fp_load_span_and_unpack_gather_unzigzag(gpu):
    """The word-lengths chain (LOAD -> SPAN) and the PS_SUPPKEY chain (UNPACK ->
    GATHER -> UNZIGZAG) at a length off the tile, with signed narrow LOADs."""
    rng = np.random.default_rng(15)
    n = 1_000_003
    env, _ = _packed(11, n, rng, gpu)
    env["t"] = torch.from_numpy(rng.integers(-2**31, 2**31, 2048).astype(np.int32)).to(gpu)
    env["offs"] = torch.from_numpy(np.sort(rng.integers(0, 10**7, 5000)).astype(np.int32)).to(gpu)
    _fp_check(_fp(UNPACK_OP + (gather("t"), unzigzag()), ("p", "bw", "base", "t"), n), env)
    for dt in (np.int32, np.int16, np.int8, np.uint8):
        info = np.iinfo(dt)
        env["x"] = torch.from_numpy(rng.integers(max(info.min, -50), min(info.max, 6000), n)
                                    .astype(dt)).to(gpu)
        _fp_check(_fp((load("x"), span("offs")), ("x", "offs"), n), env)


def test_fp_gather_tables(gpu):
    """Gathers from a table larger than L1 holds for a block's warps, from a
    uint8 table at an odd address whose size is not a multiple of 4, and from
    tables behind other transforms (op by op over a thread's 4 values)."""
    rng = np.random.default_rng(16)
    n = 300_007
    env, _ = _packed(14, n, rng, gpu)
    raw8 = torch.from_numpy(rng.integers(0, 256, 4000).astype(np.uint8)).to(gpu)
    env.update({"big": torch.from_numpy(rng.integers(-2**31, 2**31, 5000)
                                        .astype(np.int32)).to(gpu),
                "u8": raw8[3:3 + 1001],
                "t": torch.from_numpy(rng.integers(-2**31, 2**31, 999).astype(np.int32))
                .to(gpu)})
    for chain, out_dtype in ((UNPACK_OP + (gather("big"),), np.int32),
                             (UNPACK_OP + (gather("u8"),), np.uint8),
                             (UNPACK_OP + (unzigzag(), gather("t")), np.int32),
                             (UNPACK_OP + (gather("big"), unzigzag(), gather("t")), np.int32)):
        ins = tuple(dict.fromkeys(b for op in chain for b in op.bufs))
        _fp_check(_fp(chain, ins, n, out_dtype), env)


# ------------------------------------- chunk and span entries (streamed decode)

WIDTH_TABLES = {1: np.uint8, 2: np.uint16, 4: np.int32}


@pytest.mark.parametrize("width", [1, 2, 4])
def test_fp_chunk_entry_writes_its_range_in_place(width, gpu):
    """Kernel 1's chunk entry: a chunk of ``n`` outputs decoded from its own
    slice of the packed words (from word 0, at chunk starts that are multiples
    of 32) into its range of the column, at every output width; LOAD chunks at
    any start, so their range is off the 16-byte boundary; tails of 1-15."""
    rng = np.random.default_rng(40 + width)
    total = 200_000
    dt = WIDTH_TABLES[width]
    env, _ = _packed(13, total, rng, gpu)
    env["t"] = torch.from_numpy(rng.integers(0, np.iinfo(dt).max, 8192).astype(dt)).to(gpu)
    env["x"] = torch.from_numpy(rng.integers(0, 8192, total).astype(np.int32)).to(gpu)
    unp = _fp(UNPACK_OP + (gather("t"),), ("p", "bw", "base", "t"), total, dt)
    lod = _fp((load("x"), gather("t")), ("x", "t"), total, dt)
    for st, starts, align in ((unp, range(0, total - 64, 32 * 997), 32),
                              (lod, range(3, total - 64, 4099), 1)):
        whole = ref.fully_parallel_torch(st, env)
        for s in starts:
            for n in list(range(1, 16)) + [33, 4096 + 7, min(3 * FP_TILE + 5, total - s)]:
                n = min(n, total - s)
                local = dict(env)
                if st is unp:
                    local["p"] = env["p"][s * 13 // 32:]
                else:
                    local["x"] = env["x"][s:s + n]
                out = torch.full((total,), 7, dtype=whole.dtype, device=gpu)
                before = FP.launches
                got = fully_parallel(st, local, n=n, out=out[s:s + n])
                assert FP.launches == before + 1 and got.data_ptr() == out[s:].data_ptr()
                assert torch.equal(out[s:s + n], whole[s:s + n]), (s, n, align)
                assert torch.equal(out[:s], torch.full_like(out[:s], 7))
                assert torch.equal(out[s + n:], torch.full_like(out[s + n:], 7))
                plain = ref.fully_parallel_torch(st, local, n)
                assert torch.equal(plain, whole[s:s + n])


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("map_kind", [IDENTITY, AFFINE, STRGATHER])
def test_gp_span_entry_writes_its_range_in_place(map_kind, width, gpu):
    """Kernel 2's span entry: the whole presum, the span's slices of the value
    leaves (values at g - g_start), outputs written from ``out_start`` in place,
    at out offsets off the 16-byte boundary, spans of 1-15 outputs, a span
    cut inside a group (``n_valid`` below the span's outputs) and long spans
    through the unrolled 16-byte stores; each map at each output width."""
    rng = np.random.default_rng(50 + width)
    counts = rng.integers(1, 40, 30_000)
    counts[rng.random(counts.size) < 0.2] = 0
    presum = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    n_out = int(presum[-1])
    names = {IDENTITY: ("vals",), AFFINE: ("vals", "strides"), STRGATHER: ("words",)}[map_kind]
    dt = WIDTH_TABLES[width]
    env = {"presum": torch.from_numpy(presum).to(gpu),
           "vals": torch.from_numpy(rng.integers(0, 1000, counts.size).astype(np.int32)).to(gpu),
           "strides": torch.from_numpy(rng.integers(-9, 9, counts.size).astype(np.int32)).to(gpu),
           "words": torch.from_numpy(rng.integers(0, 1000, counts.size).astype(np.int32)).to(gpu),
           "chars": torch.from_numpy(rng.integers(0, 256, 50_000).astype(np.uint8)).to(gpu),
           "offs": torch.from_numpy(np.sort(rng.integers(0, 49_000, 1001)).astype(np.int32)).to(gpu),
           "t": torch.from_numpy(rng.integers(0, np.iinfo(dt).max, 1 << 16).astype(dt)).to(gpu)}
    st = GroupParallel(presum="presum", value_inputs=names,
                       value_specs=(BufSpec("tile"),) * len(names),
                       values=tuple((load(k),) for k in names), map_kind=map_kind,
                       tail=(gather("t"),) if width != (1 if map_kind == STRGATHER else 4) else (),
                       extra_inputs=("chars", "offs") if map_kind == STRGATHER else (),
                       out_dtype=dt, out="out", n_out=n_out, n_groups=counts.size, name="span")
    whole = ref.group_parallel_torch(st, env)
    spans = [(int(g0), int(g1)) for g0, g1 in rng.integers(0, counts.size, (40, 2))
             if g0 < g1] + [(0, counts.size), (17, 18), (counts.size - 3, counts.size)]
    for g0, g1 in spans:
        start, stop = int(presum[g0]), int(presum[g1])
        for n_valid in {stop - start, max(1, (stop - start) // 3), 1, 7, 15}:
            n_valid = min(n_valid, stop - start)
            if n_valid <= 0:
                continue
            local = dict(env)
            for k in names:
                local[k] = env[k][g0:g1]
            out = torch.full((n_out,), 3, dtype=whole.dtype, device=gpu)
            before = GP.launches
            group_parallel(st, local, out=out[start:start + n_valid], out_start=start,
                           g_start=g0, n_valid=n_valid, g_size=g1 - g0)
            assert GP.launches == before + 1
            assert torch.equal(out[start:start + n_valid], whole[start:start + n_valid]), \
                (g0, g1, n_valid)
            assert torch.equal(out[:start], torch.full_like(out[:start], 3))
            assert torch.equal(out[start + n_valid:], torch.full_like(out[start + n_valid:], 3))
            plain = ref.group_parallel_torch(st, local, start, g0, n_valid)
            assert torch.equal(plain, whole[start:start + n_valid])


@pytest.mark.parametrize("kind", ["uint8", "int32"])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_np_span_entry_on_row_capped_stripes(kind, width, gpu):
    """Kernel 3's span entry: each span's stripe ``streams[:row_cap, g0:g1]``
    (``max_words`` = its own rows), its states, its symbols written in place
    from ``g0 * chunk_size``, the last span cut at the end of the stream; a
    rule-4 tail gives 2- and 4-byte outputs."""
    rng = np.random.default_rng(60 + width)
    arr = ans_sweep_input(kind, 300_001, rng)
    enc = encode(Plan("ans", params={"chunk_size": 1000}), arr)
    ex = StreamingExecutor("torch", "cpu", chunk_bytes=20_000, chunk_decode=True)
    ex.compile("c", enc)
    sched = ex.chunk_schedule("c")
    st = ex.graph("c").stages[0]
    assert sched is not None and sched.n_chunks > 3
    env = device_buffers(enc, gpu)
    dt = WIDTH_TABLES[width]
    if width != 1:
        env["t"] = torch.from_numpy(rng.integers(0, np.iinfo(dt).max, 256).astype(dt)).to(gpu)
        st = dataclasses.replace(st, tail=(gather("t"),), out_dtype=dt)
    whole = ref.non_parallel_torch(st, env)
    ops = host_operands(enc)
    for k in range(sched.n_chunks):
        local = dict(env)
        for leaf in (st.streams, st.states):
            piece = np.ascontiguousarray(sched.piece(np.asarray(ops[leaf]), leaf, k))
            local[leaf] = torch.from_numpy(piece.view(np.int32) if piece.dtype == np.uint32
                                           else piece).to(gpu)
        g0, gz = sched.g_starts[k], sched.g_sizes[k]
        s = g0 * st.chunk_size
        n = min(gz * st.chunk_size, st.n_out - s)
        for off in (0, 1, 5):           # the span's range off the 16-byte boundary
            out = torch.full((st.n_out + off,), 9, dtype=whole.dtype, device=gpu)
            before = NP.launches
            non_parallel(st, local, n_chunks=gz, n=n, out=out[off + s:off + s + n])
            assert NP.launches == before + 1
            assert torch.equal(out[off + s:off + s + n], whole[s:s + n]), (k, off)
            assert torch.equal(out[:off + s], torch.full_like(out[:off + s], 9))
        assert torch.equal(ref.non_parallel_torch(st, local, gz, n), whole[s:s + n])


def test_strgather_uint16_offsets_on_the_card(gpu):
    """A uint16 offsets buffer: the plain version indexes it through
    ``ref.take`` (torch has no CUDA indexing for uint16), and the kernel reads
    it at its own width."""
    rng = np.random.default_rng(70)
    chars = torch.from_numpy(rng.integers(0, 256, 3000).astype(np.uint8)).to(gpu)
    offs = np.sort(rng.integers(0, 2900, 60))
    words = rng.integers(0, 59, 400).astype(np.int32)
    counts = np.diff(offs)[words]
    presum = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    st = GroupParallel(presum="presum", value_inputs=("words",),
                       value_specs=(BufSpec("tile"),), values=((load("words"),),),
                       map_kind=STRGATHER, extra_inputs=("chars", "offs"), out="out",
                       n_out=int(presum[-1]), n_groups=words.size, out_dtype=np.uint8)
    env = {"presum": torch.from_numpy(presum).to(gpu),
           "words": torch.from_numpy(words).to(gpu), "chars": chars,
           "offs": torch.from_numpy(offs.astype(np.uint16)).to(gpu)}
    want = torch.cat([chars[int(offs[w]):int(offs[w + 1])] for w in words.tolist()])
    plain = ref.group_parallel_torch(st, env)
    assert torch.equal(plain, want)
    assert torch.equal(group_parallel(st, env), want)


@pytest.mark.parametrize("chunk_bytes", [256, 4096])
def test_chunked_pipeline_on_the_card(chunk_bytes, gpu):
    """All 24 Table-2 columns through ``ColumnPipeline(chunk_decode=True)``:
    element chunks on kernel 1, L_RETURNFLAG's spans on kernel 3, every column
    equal to its source, as many decode units as the schedules give."""
    cols = {k: v for k, v in generate(0.002, seed=0).items() if k in TABLE2_PLANS}
    pipe = ColumnPipeline(dict(TABLE2_PLANS), device=gpu, chunk_bytes=chunk_bytes,
                          chunk_decode=True)
    pipe.compress(cols)
    before = (FP.launches, NP.launches)
    res = pipe.run()
    assert FP.launches > before[0] and NP.launches > before[1]
    for k, arr in cols.items():
        assert torch.equal(bits(res[k].array.cpu()), bits(torch.from_numpy(arr))), k
        sched = pipe.executor.chunk_schedule(k)
        assert res[k].decode_launches == (1 if sched is None else sched.n_chunks)
    assert res["L_RETURNFLAG"].chunk_decoded == (chunk_bytes == 256)


def test_group_span_pipeline_on_the_card(gpu):
    """Kernel 2's span entry on the executor's path: the reference's RLE and
    DeltaStride candidate plans of the key columns, streamed in spans."""
    cols = generate(0.002, seed=0)
    plans = {"L_ORDERKEY": make_plan("rle"), "O_ORDERKEY": make_plan("deltastride")}
    pipe = ColumnPipeline(plans, device=gpu, chunk_bytes=1024, chunk_decode=True)
    pipe.compress({k: cols[k] for k in plans})
    before = GP.launches
    res = pipe.run()
    assert GP.launches > before + 2
    for k in plans:
        assert res[k].chunk_decoded and res[k].decode_launches > 2
        assert torch.equal(res[k].array.cpu(), torch.from_numpy(cols[k]))


# ------------------------------------------------------------- batched entries

def _batched_members(kind: str):
    """Blobs of one structure whose data differ, per kernel."""
    rng = np.random.default_rng(11)
    if kind == "fp":                                        # kernel 1 and the f2i patch
        cols = generate(0.01, seed=0)
        arrs = [cols["L_DISCOUNT"], cols["L_TAX"]]
        return [encode(TABLE2_PLANS[k], cols[k]) for k in ("L_DISCOUNT", "L_TAX")], arrs
    if kind == "gp":
        plan = make_plan("rle")
        vals = rng.integers(-2**31, 2**31, 20_000)
        counts = rng.integers(1, 60, 20_000)
        arrs = [np.repeat(vals, counts).astype(np.int32),
                np.repeat(vals, counts[::-1]).astype(np.int32)]
    else:                                                    # kernel 3
        plan = Plan("ans", params={"chunk_size": 1000})
        a = rng.integers(0, 30, 300 * 1000).astype(np.uint8)
        arrs = [a, a.reshape(300, 1000)[rng.permutation(300)].reshape(-1)]
    return [encode(plan, a) for a in arrs], arrs


@pytest.mark.parametrize("k", [1, 2, 8, 13])
@pytest.mark.parametrize("kind", ["fp", "gp", "np"])
def test_batched_entry_matches_single_launches(kind, k, gpu):
    """``Program.batched`` on the kernel backend: one batched launch per stage
    and per the kernel's limit of members, each member equal to its single
    decode and to its source."""
    encs, arrs = _batched_members(kind)
    graphs = [build_graph(e) for e in encs]
    assert graphs[0].signature == graphs[1].signature
    prog = compile_blob(encs[0], backend="kernel")
    lib = {"fp": FP, "gp": GP, "np": NP}[kind]
    members = [device_buffers(encs[i % 2], gpu) for i in range(k)]
    before = lib.batched_launches
    out = prog.batched(members)
    torch.cuda.synchronize()
    assert lib.batched_launches - before == -(-k // lib.batch_max)
    for i, m in enumerate(members):
        assert torch.equal(bits(out[i]), bits(prog(m)))
        assert torch.equal(bits(out[i].cpu()), bits(torch.from_numpy(arrs[i % 2])))
    plain = compile_blob(encs[0], backend="torch").batched(members)
    assert torch.equal(bits(out), bits(plain))


def test_planned_pipeline_on_the_card(gpu):
    """The reference's defaults and adaptive/auto plans run on the card, every
    column batched as the same plan batches it on the CPU; under the defaults
    the same-structure pair decodes in one batched kernel-1 launch a run."""
    cols = generate(0.01, seed=0)
    pipe = ColumnPipeline(dict(TABLE2_PLANS))
    pipe.compress({k: cols[k] for k in TABLE2_PLANS})
    host = ColumnPipeline(dict(TABLE2_PLANS), device="cpu")
    host.load({k: pipe.encoded(k) for k in TABLE2_PLANS})
    for kw in ({}, dict(policy="adaptive", chunk_bytes="auto", chunk_decode=True)):
        plan = pipe.plan(**kw)
        want = host.run(plan=plan)
        for _ in range(2):
            for lib in (FP, GP, NP):
                lib.batched_launches = 0
            res = pipe.run(plan=plan)
            for k in TABLE2_PLANS:
                assert torch.equal(bits(res[k].array.cpu()), bits(torch.from_numpy(cols[k])))
                assert res[k].batched_with == want[k].batched_with, k
        if not kw:
            assert res["L_DISCOUNT"].batched_with == ("L_TAX",)
            assert (FP.batched_launches, GP.batched_launches, NP.batched_launches) == (1, 0, 0)


# ------------------------------------------------------- kernel 4: fused queries
# The count lane (sums of 0/1 or of run lengths, integers below 2^24) must be
# bitwise equal to the plain version's; the float lanes agree within 1e-5
# relative: every row's values are the same bits (the kernel's _rn
# intrinsics), and the kernel's block-tree sums and the plain version's
# torch.sum differ only in the order of the additions.  Each query has its own
# generated kernel; the module's are built at once (``query_kernels``).
QUERY_RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _tpch(scale: float) -> dict:
    return generate(scale, seed=0)


def _tpch_query(q: int, scale: float):
    """TPC-H Q1 or Q6 lowered onto SF-``scale`` columns: (FusedQuery, columns)."""
    from repro_torch.core.query import lower_query
    from repro_torch.data.queries import Q1_PLAN, Q6_PLAN
    from repro_torch.data.tpch import QUERY_COLUMNS

    cols = _tpch(scale)
    encs = {n: encode(TABLE2_PLANS[n], cols[n]) for n in QUERY_COLUMNS[q]}
    return lower_query({1: Q1_PLAN, 6: Q6_PLAN}[q], encs), cols


# small queries on the expression semantics the kernel program must keep
# (also held against the reference on the CPU, test_torch_query_run.py)
def semantics_columns():
    rng = np.random.default_rng(7)
    n = 5000
    return {"A": rng.integers(0, 100, n).astype(np.int32),
            "F": rng.integers(0, 256, n).astype(np.uint8),
            "S": rng.integers(-300, 300, n).astype(np.int16),
            "X": (rng.integers(-5000, 5000, n) / 100.0).astype(np.float32)}


SEMANTICS = {
    # floor modulo of negatives, as a lane and as the key
    "floor-mod": QueryPlan(
        "fmod", aggregates=(("m", Bin("%", Bin("-", Col("A"), Const(50)), Const(7))),
                            ("xm", Bin("%", Col("X"), Const(-3.5)))),
        group_key=Bin("%", Bin("-", Col("A"), Const(50)), Const(7)),
        n_segments=7),
    # uint8 + a Python int stays uint8 (wraps); int16 * int16 stays int16
    "narrow-wrap": QueryPlan(
        "wrap", aggregates=(("u", Bin("+", Col("F"), Const(250))),
                            ("s", Bin("*", Col("S"), Col("S"))),
                            ("us", Bin("+", Col("F"), Col("S"))))),
    # int * float -> float32; a float bound on an int value column; keys past
    # the segments drop their rows (count lane included)
    "promote-drop": QueryPlan(
        "promote", predicates=(Pred("A", "<", 80.5), Pred("X", ">=", -20)),
        aggregates=(("h", Bin("*", Col("A"), Const(0.5))),
                    ("x", Bin("-", Const(1), Col("X")))),
        group_key=Bin("-", Col("A"), Const(40)), n_segments=16),
    # a float predicate on a column no aggregate reads: a post-decode mask
    "post-decode": QueryPlan(
        "postdec", predicates=(Pred("X", "between", -10.25, 30.5),
                               Pred("S", "<", 0.5)),
        aggregates=(("a", Col("A", "float32")),)),
}


def _semantics_query(case: str):
    from repro_torch.core.query import lower_query

    cols = semantics_columns()
    plans = {k: make_plan("bitpack") for k in "AFS"}
    plans["X"] = Plan("float2int", children={"ints": make_plan("bitpack")})
    qp = SEMANTICS[case]
    return lower_query(qp, {c: encode(plans[c], cols[c]) for c in qp.columns()})


def _rle_case():
    """A per-run RLE graph (a weight role) and a compressed-domain range on
    32-bit fields whose int32 ``v + base`` wraps: (graph, blob, wide query,
    wide column)."""
    from repro_torch.algos.rle import run_reduce_graph
    from repro_torch.core.query import lower_query

    rng = np.random.default_rng(3)
    values = np.cumsum(rng.integers(1, 4, 40_000)).astype(np.int32)
    arr = np.repeat(values, rng.integers(1, 60, 40_000)).astype(np.int32)
    enc = encode(Plan("rle", children={"counts": make_plan("bitpack"),
                                       "values": make_plan("bitpack")}), arr)
    g = run_reduce_graph(enc, Pred("root", ">=", int(np.quantile(values, 0.3))),
                         [Bin("*", Col("root"), Const(2))], digest="t")
    wide = np.concatenate([[-2**31 + 5, 2**31 - 3],
                           rng.integers(-2**31, 2**31, 100_000)]).astype(np.int32)
    qp = QueryPlan("wide", predicates=(Pred("W", "between", -5, 7 * 10**8),),
                   aggregates=(("v", Col("V")),))
    fq = lower_query(qp, {"W": encode(make_plan("bitpack"), wide),
                          "V": encode(make_plan("bitpack"), wide % 1000)})
    return g, enc, fq, wide


def _fma_case():
    """A lane ``x * y + z`` whose first row an FMA would round differently:
    (FusedQuery, the unfused float32 value of row 0, the fused one)."""
    from repro_torch.core.query import lower_query

    rng = np.random.default_rng(11)
    x, y, z = ((rng.integers(-10**6, 10**6, 4096) / 100.0).astype(np.float32)
               for _ in range(3))
    unfused = (x * y) + z                                    # float32, rounded twice
    fused = (x.astype(np.float64) * y + z).astype(np.float32)
    k = int(np.flatnonzero(unfused != fused)[0])
    cols = {c: np.roll(v, -k) for c, v in zip("XYZ", (x, y, z))}
    plan = Plan("float2int", children={"ints": make_plan("bitpack")})
    qp = QueryPlan("fma", aggregates=(("f", Bin("+", Bin("*", Col("X"), Col("Y")),
                                                  Col("Z"))),))
    fq = lower_query(qp, {c: encode(plan, v) for c, v in cols.items()})
    return fq, unfused[k], fused[k]


def _query_stages():
    """Every Reduce this module launches kernel 4 on, with its inputs on the CPU."""
    from repro_torch.core.compiler import device_layout

    def host_env(fq, resident=None):
        env = {k: torch.from_numpy(device_layout(v)) for k, v in fq.operands.items()}
        for c, arr in (resident or {}).items():
            env[fq.resident_input(c)] = torch.from_numpy(arr)
        return fq.graph.stages[-1], env

    for q, scale in itertools.product((1, 6), (0.05, 0.01)):
        fq, cols = _tpch_query(q, scale)
        yield host_env(fq, {c: cols[c] for c in fq.resident})
    for case in SEMANTICS:
        yield host_env(_semantics_query(case))
    g, enc, fq, _ = _rle_case()
    yield g.stages[0], {k: torch.from_numpy(device_layout(v))
                        for k, v in host_operands(enc).items()}
    yield host_env(fq)
    yield host_env(_fma_case()[0])


@pytest.fixture(scope="module")
def query_kernels():
    """Build every generated kernel of this module in one ``cuda.build`` (one
    nvcc per source, all at once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import cuda
    from repro_torch.kernels.query_reduce import library, program

    progs = [program(red, env) for red, env in _query_stages()]   # CPU inputs: nothing built
    cuda.build([library(p.source) for p in progs])
    return progs


def _query_env(fq, gpu, resident=None):
    from repro_torch.core.compiler import device_layout

    env = {k: torch.from_numpy(device_layout(v)).to(gpu) for k, v in fq.operands.items()}
    for c, arr in (resident or {}).items():
        env[fq.resident_input(c)] = torch.from_numpy(arr).to(gpu)
    return env


def _assert_query_lanes(got, plain, n_segments):
    assert torch.equal(got[-n_segments:], plain[-n_segments:])
    torch.testing.assert_close(got, plain, rtol=QUERY_RTOL, atol=0)


@pytest.mark.usefixtures("query_kernels")
@pytest.mark.parametrize("q", [1, 6])
@pytest.mark.parametrize("chunks", [1, 3])
def test_query_kernel_matches_plain(q, chunks, gpu):
    """Q1 (resident L_RETURNFLAG, a 5-lane x 8-segment accumulator) and Q6 on
    the query kernel, whole and in chunks added into one accumulator."""
    from repro_torch.core.executor import StreamingExecutor
    from repro_torch.kernels.query_reduce import KERNEL as QR, query_reduce

    fq, cols = _tpch_query(q, 0.05)
    red = fq.graph.stages[-1]
    whole_env = _query_env(fq, gpu, {c: cols[c] for c in fq.resident})
    plain = ref.query_reduce_torch(red, whole_env)
    ex = StreamingExecutor("torch", gpu, chunk_bytes=None)    # for its schedule
    cb = None if chunks == 1 else -(-sum(v.nbytes for v in fq.operands.values()) // chunks)
    sched = ex.query_schedule(fq, cb)
    assert sched.n_chunks == chunks or (chunks > 1 and sched.n_chunks > 1)
    acc = torch.empty(red.n_out, dtype=torch.float32, device=gpu)
    before = QR.launches
    for k in range(sched.n_chunks):
        env = dict(whole_env)
        for leaf, sl in sched.slices.items():
            lo, hi = sl[k]
            env[leaf] = whole_env[leaf][lo:hi].contiguous()
        query_reduce(red, env, n=sched.out_sizes[k], out_start=sched.out_starts[k],
                     out=acc, accumulate=k > 0)
    torch.cuda.synchronize()
    assert QR.launches - before == sched.n_chunks
    _assert_query_lanes(acc, plain, fq.n_segments)
    # the same launch twice gives the same bits (no float atomics)
    again = query_reduce(red, whole_env)
    assert torch.equal(again, query_reduce(red, whole_env))


@pytest.mark.usefixtures("query_kernels")
@pytest.mark.parametrize("case", ["floor-mod", "narrow-wrap", "promote-drop", "post-decode"])
def test_query_kernel_expression_semantics(case, gpu):
    from repro_torch.kernels.query_reduce import query_reduce

    fq = _semantics_query(case)
    red = fq.graph.stages[-1]
    env = _query_env(fq, gpu)
    _assert_query_lanes(query_reduce(red, env), ref.query_reduce_torch(red, env),
                        fq.n_segments)


@pytest.mark.usefixtures("query_kernels")
def test_query_kernel_rle_runs_and_compare_masks(gpu):
    """The per-run RLE graph (a weight role) and a compressed-domain range on
    32-bit fields whose int32 ``v + base`` wraps."""
    from repro_torch.kernels.query_reduce import query_reduce

    g, enc, fq, wide = _rle_case()
    env = device_buffers(enc, gpu)
    (red,) = g.stages
    _assert_query_lanes(query_reduce(red, env), ref.query_reduce_torch(red, env), 1)
    red = fq.graph.stages[-1]
    env = _query_env(fq, gpu)
    got = query_reduce(red, env)
    _assert_query_lanes(got, ref.query_reduce_torch(red, env), 1)
    assert got[-1].item() == float(((wide >= -5) & (wide <= 7 * 10**8)).sum())


@pytest.mark.usefixtures("query_kernels")
@pytest.mark.parametrize("chunk_bytes", [None, 4096])
def test_query_pipeline_on_the_card(chunk_bytes, gpu):
    """``ColumnPipeline.run_query`` on the card against the same pipeline on
    the CPU: Q1 (resident L_RETURNFLAG through ``run``) and Q6, one kernel-4
    launch per chunk."""
    from repro_torch.data.queries import Q1_PLAN, Q6_PLAN
    from repro_torch.data.tpch import QUERY_COLUMNS
    from repro_torch.kernels.query_reduce import KERNEL as QR

    cols = _tpch(0.01)
    for qp, q in ((Q1_PLAN, 1), (Q6_PLAN, 6)):
        names = QUERY_COLUMNS[q]
        pipe = ColumnPipeline({n: TABLE2_PLANS[n] for n in names}, device=gpu,
                              chunk_bytes=chunk_bytes, chunk_decode=True)
        pipe.compress({n: cols[n] for n in names})
        host = ColumnPipeline({n: TABLE2_PLANS[n] for n in names}, device="cpu",
                              chunk_bytes=chunk_bytes, chunk_decode=True)
        host.load({n: pipe.encoded(n) for n in names})
        want = host.run_query(qp)
        for _ in range(2):
            before = QR.launches
            qe = pipe.run_query(qp)
            assert QR.launches - before == qe.n_chunks == want.n_chunks
            _assert_query_lanes(qe.acc.cpu(), want.acc, qe.acc.numel()
                                // (len(qp.aggregates) + 1))
            assert qe.makespan_s > 0 and qe.decode_s > 0


@pytest.mark.usefixtures("query_kernels")
def test_a_second_program_of_the_same_structure_builds_nothing(gpu):
    """Two lowerings of one query are two programs of one kernel: the second
    builds nothing and loads the library that the first built, in this
    process or from ``build/`` in another."""
    from repro_torch.kernels import query_reduce as qr

    fq, cols = _tpch_query(6, 0.05)
    first = qr.program(fq.graph.stages[-1], _query_env(fq, gpu))
    fq2, _ = _tpch_query(6, 0.05)
    second = qr.program(fq2.graph.stages[-1], _query_env(fq2, gpu))
    assert second is not first and second.source == first.source
    assert second.build_s is None and second.lib is first.lib and second.lib.loaded
    lib = qr._LIBRARIES.pop(first.lib.digest)        # as a fresh process finds it
    try:
        fq3, _ = _tpch_query(6, 0.05)
        third = qr.program(fq3.graph.stages[-1], _query_env(fq3, gpu))
        assert third.build_s is None and third.lib is not lib and third.lib.loaded
        assert third.lib.build_s is None and third.lib.path() == lib.path()
    finally:
        qr._LIBRARIES[lib.digest] = lib


@pytest.mark.usefixtures("query_kernels")
def test_generated_lane_is_not_contracted_into_an_fma(gpu):
    """A lane ``x * y + z`` on a row where an FMA rounds differently: the
    single-row launch equals the plain version bitwise, and the unfused
    float32 value, not the fused one."""
    from repro_torch.kernels.query_reduce import query_reduce

    fq, unfused, fused = _fma_case()
    assert unfused != fused
    red = fq.graph.stages[-1]
    env = _query_env(fq, gpu)
    got = query_reduce(red, env, n=1)
    plain = ref.query_reduce_torch(red, env, n=1)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    assert got[0].item() == float(unfused) != float(fused) and got[1].item() == 1.0


# ------------------------------------------------------ dispatch and serving

def _serve_blobs(names, scale: float = 0.01) -> dict:
    cols = _tpch(scale)
    return {n: encode(TABLE2_PLANS[n], cols[n]) for n in names}


def _check_request(req, scale: float = 0.01):
    cols = _tpch(scale)
    assert req.done and req.error is None, (req.rid, req.error)
    assert set(req.results) == set(req.encs)
    for c, r in req.results.items():
        assert torch.equal(bits(r.array.cpu()), bits(torch.from_numpy(cols[c]))), (req.rid, c)


@pytest.mark.parametrize("window", [1, 2, 3])
def test_worker_issuance_on_the_card_holds_the_window(window, gpu, monkeypatch):
    """The transfer thread's copies against the inline issuer's, bitwise, at
    1 KiB chunks with per-chunk decode: unit u's copies are issued only once
    unit u - window's decode is recorded, so no more than ``window`` units'
    copies are in flight, and no copy stream wait is placed on an event that
    does not exist yet."""
    from repro_torch.core import executor as E

    cols = {k: v for k, v in _tpch(0.002).items() if k in TABLE2_PLANS}
    pipe = ColumnPipeline(dict(TABLE2_PLANS), device=gpu, chunk_bytes=1024,
                          chunk_decode=True, policy="fifo")
    pipe.compress(cols)
    plan = pipe.plan()
    decoded, ahead, waits = [0], [], []
    issue, decode = E._CudaLeg.issue, StreamingExecutor._decode

    def watching_issue(leg, u):
        ahead.append(u - decoded[0])
        if u >= leg.window:
            waits.append(len(leg.decoded_ev) > u - leg.window)
        issue(leg, u)

    def counting_decode(self, unit, flats, cols_):
        decode(self, unit, flats, cols_)
        decoded[0] += 1

    monkeypatch.setattr(E._CudaLeg, "issue", watching_issue)
    monkeypatch.setattr(StreamingExecutor, "_decode", counting_decode)
    runs = {}
    for mode in (False, True):
        decoded[0], ahead[:] = 0, []
        before = _launches()
        runs[mode] = pipe.executor.run(plan=plan, window=window, async_dispatch=mode)
        assert _launches() > before
        assert max(ahead) <= window - 1 and all(waits)
    for k, arr in cols.items():
        assert torch.equal(bits(runs[True][k].array), bits(runs[False][k].array)), k
        assert torch.equal(bits(runs[True][k].array.cpu()), bits(torch.from_numpy(arr))), k
        assert runs[True][k].kernel_launches == runs[False][k].kernel_launches, k
    assert not [t for t in threading.enumerate() if t.name == "zipflow-xfer"]


def test_on_ready_fires_only_after_the_column_is_decoded(gpu, monkeypatch):
    """``on_ready(name)`` is called once per column, batched members included,
    and only once an event recorded right after the column's last decode is
    complete on the device."""
    from repro_torch.data.tpch import QUERY_COLUMNS

    names = QUERY_COLUMNS[1]
    cols = _tpch(0.01)
    pipe = ColumnPipeline({c: TABLE2_PLANS[c] for c in names}, device=gpu)
    pipe.compress({c: cols[c] for c in names})
    marks = {}
    decode = StreamingExecutor._decode

    def marking_decode(self, unit, flats, cols_):
        decode(self, unit, flats, cols_)
        ev = torch.cuda.Event()
        ev.record()
        for m in unit.members:
            marks[m] = ev

    monkeypatch.setattr(StreamingExecutor, "_decode", marking_decode)
    plan = pipe.plan()
    for mode in (False, True):
        seen = []

        def on_ready(name):
            assert marks[name].query(), f"{name} reported before its decode completed"
            seen.append(name)

        res = pipe.executor.run(plan=plan, on_ready=on_ready, async_dispatch=mode)
        assert sorted(seen) == sorted(names) and len(seen) == len(set(seen))
        assert res["L_DISCOUNT"].batched_with == ("L_TAX",)
        for c in names:
            assert torch.equal(bits(res[c].array.cpu()), bits(torch.from_numpy(cols[c]))), c


@pytest.mark.parametrize("mode", [False, True], ids=["inline", "async"])
def test_nested_run_mid_chunked_column(mode, gpu):
    """A preemptive ``run_one`` between two chunks of a per-chunk-decode
    column, on the same executor and streams: both bitwise, and the outer
    columns' ``kernel_launches`` are those of a run without the cut-in."""
    from repro_torch.data.tpch import QUERY_COLUMNS

    cols = _tpch(0.01)
    names = QUERY_COLUMNS[6]
    pipe = ColumnPipeline({c: TABLE2_PLANS[c] for c in names}, device=gpu,
                          chunk_bytes=1 << 13, chunk_decode=True, policy="fifo")
    pipe.compress({c: cols[c] for c in names})
    plan = pipe.plan()
    alone = pipe.executor.run(plan=plan, async_dispatch=mode)
    pt = encode(TABLE2_PLANS["O_ORDERKEY"], cols["O_ORDERKEY"])
    calls, nested = [0], []

    def preempt():
        calls[0] += 1
        if calls[0] in (1, 3):          # inside the first chunked column
            nested.append(pipe.executor.run_one(pt, name=f"pt{calls[0]}/O_ORDERKEY"))

    res = pipe.executor.run(plan=plan, preempt=preempt, async_dispatch=mode)
    assert res[plan.order[0]].chunk_decoded and len(nested) == 2
    for arr in nested:
        assert torch.equal(arr.cpu(), torch.from_numpy(cols["O_ORDERKEY"]))
    for c in names:
        assert torch.equal(bits(res[c].array.cpu()), bits(torch.from_numpy(cols[c]))), c
        assert res[c].kernel_launches == alone[c].kernel_launches > 0, c
    assert "pt1/O_ORDERKEY" not in pipe.executor._encoded


def test_wave_on_a_background_thread(gpu):
    """The drain loop's thread runs the waves: its launches go to the stream
    its events are recorded on, and every column of every request is bitwise
    its source."""
    from repro_torch.data.tpch import QUERY_COLUMNS

    pipe = ColumnPipeline(dict(TABLE2_PLANS), device=gpu, chunk_bytes="auto",
                          chunk_decode=True, policy="adaptive")
    sp = pipe.serve_planner("shared").start()
    before = _launches()
    try:
        reqs = [sp.submit(f"r{i}", _serve_blobs(QUERY_COLUMNS[q]))
                for i, q in enumerate((1, 6, 13, 6))]
        for r in reqs:
            assert r.wait(timeout=300.0), r.rid
    finally:
        sp.stop()
    assert _launches() > before and sp.reports
    for r in reqs:
        _check_request(r)
        assert r.latency_s > 0
    assert all(rep.makespan_s > 0 for rep in sp.reports)
    assert not [t for t in threading.enumerate()
                if t.name in ("zipflow-xfer", "zipflow-serve-drain")]


def test_serving_wave_batches_kernel_1_across_requests(gpu):
    """Q1 and Q6 twice in one shared wave: the columns of one structure of
    the four requests decode in batched kernel-1 launches of 4 to 6 members,
    each member bitwise its source; the same members launched singly agree."""
    from repro_torch.data.tpch import QUERY_COLUMNS

    pipe = ColumnPipeline(dict(TABLE2_PLANS), device=gpu, chunk_bytes=None,
                          policy="adaptive")
    sp = pipe.serve_planner("shared")
    FP.largest_batch = 0
    reqs = [sp.submit(f"r{i}", _serve_blobs(QUERY_COLUMNS[q]))
            for i, q in enumerate((1, 6, 1, 6))]
    sp.drain()
    for r in reqs:
        _check_request(r)
    assert 4 <= FP.largest_batch <= 6
    assert sp.reports[-1].cross_batched_saved > 0
    # K = 4-6 members of L_DISCOUNT's structure against single launches
    blobs = [_serve_blobs(["L_DISCOUNT", "L_TAX"])[c] for c in ("L_DISCOUNT", "L_TAX")]
    prog = compile_blob(blobs[0], backend="kernel")
    for k in (4, 5, 6):
        members = [device_buffers(blobs[i % 2], gpu) for i in range(k)]
        out = prog.batched(members)
        for i, m in enumerate(members):
            assert torch.equal(bits(out[i]), bits(prog(m))), (k, i)


def test_serve_planner_builds_a_card_executor_by_default(gpu):
    """``ServePlanner()`` alone serves on the card with the kernel backend."""
    from repro_torch.core.serve_planner import ServePlanner

    sp = ServePlanner()
    assert sp.executor.device.type == "cuda" and sp.executor.backend == "kernel"
    before = _launches()
    req = sp.submit("r", _serve_blobs(["L_TAX", "L_RETURNFLAG", "O_ORDERKEY"]))
    sp.drain()
    assert _launches() > before
    _check_request(req)


# ----------------------------------------------- wide queries, geometry, baseline

@pytest.mark.parametrize("name", ["lanes17", "lanes4_seg16", "lanes7_seg32", "lanes1_seg256",
                                  "const_lane"])
def test_wide_queries_on_the_card(name, gpu):
    """Queries past the removed interpreter's limits, and a column-free
    aggregate, through ``ColumnPipeline.run_query`` on kernel 4 (registers,
    shared and global accumulators; 256 and 512 of them, more than a block's
    threads): the count lane exactly and the lanes within rtol 1e-4 of the
    same pipeline on the CPU, one launch per chunk, and the launch against
    its plain version on the card."""
    from repro_torch.data.queries import CONST_LANE_PLAN, WIDE_PLANS
    from repro_torch.kernels.query_reduce import KERNEL as QR, program, query_reduce

    qp = CONST_LANE_PLAN if name == "const_lane" else WIDE_PLANS[name]
    names = qp.columns()
    cols = _tpch(0.01)
    pipe = ColumnPipeline({n: TABLE2_PLANS[n] for n in names}, device=gpu)
    pipe.compress({n: cols[n] for n in names})
    host = ColumnPipeline({n: TABLE2_PLANS[n] for n in names}, device="cpu")
    host.load({n: pipe.encoded(n) for n in names})
    want = host.run_query(qp)
    before = QR.launches
    got = pipe.run_query(qp)
    assert QR.launches - before == got.n_chunks >= 1
    S = qp.n_segments
    assert torch.equal(got.acc.cpu()[-S:], want.acc[-S:])
    torch.testing.assert_close(got.acc.cpu(), want.acc, rtol=1e-4, atol=0)
    if name == "const_lane":
        assert float(got.acc[0]) == 2.5 * float(got.acc[-1])
    fq, _ = pipe.lower_query(qp)
    red = fq.graph.stages[-1]
    env = _query_env(fq, gpu)
    assert program(red, env).acc_place == {"lanes17": "registers", "const_lane": "registers",
                                           "lanes1_seg256": "global"}.get(name, "shared")
    _assert_query_lanes(query_reduce(red, env), ref.query_reduce_torch(red, env), S)


@pytest.mark.parametrize("pattern,geom", [("fp", Geometry(2, 512, 2)),
                                          ("gp", Geometry(8, 32, 16)),
                                          ("np", Geometry(2, 128, 2))], ids=str)
def test_programs_at_a_tuned_geometry(pattern, geom, gpu):
    """Whole columns and a batched pair decoded at a geometry off the native
    table (``compile_decoder(geometry=...)``): bitwise to the plain backend."""
    cols = _tpch(0.01)
    names = {"fp": ("L_DISCOUNT", "L_TAX"), "gp": ("O_ORDERKEY", "L_ORDERKEY"),
             "np": ("L_RETURNFLAG", "O_COMMENT")}[pattern]
    launches = {"fp": FP, "gp": GP, "np": NP}[pattern]
    for n in names:
        enc = encode(TABLE2_PLANS[n], cols[n])
        bufs = device_buffers(enc, gpu)
        before = launches.launches
        got = compile_blob(enc, backend="kernel", geometry={pattern: geom})(bufs)
        assert launches.launches > before
        plain = compile_blob(enc, backend="torch")(bufs)
        assert torch.equal(bits(got), bits(plain))
        assert torch.equal(bits(got.cpu()), bits(torch.from_numpy(cols[n])))
    if pattern == "fp":
        encs = [encode(TABLE2_PLANS[n], cols[n]) for n in names]
        prog = compile_blob(encs[0], backend="kernel", geometry={pattern: geom})
        rows = prog.batched([device_buffers(e, gpu) for e in encs])
        for r, n in zip(rows, names):
            assert torch.equal(bits(r.cpu()), bits(torch.from_numpy(cols[n])))


def test_baseline_columns_on_the_card(gpu):
    """The unfused baseline at <1,128,1> on the card: every stage a launch,
    bitwise to the fused decode and the source."""
    from repro_torch.core.compiler import compile_decoder

    cols = _tpch(0.01)
    for n in ("O_COMMENT", "L_ORDERKEY", "L_RETURNFLAG", "L_EXTENDEDPRICE"):
        enc = encode(TABLE2_PLANS[n], cols[n])
        bufs = device_buffers(enc, gpu)
        dec = compile_decoder(enc, backend="baseline")
        before = _launches()
        got = dec(bufs)
        assert _launches() > before
        assert torch.equal(bits(got), bits(compile_decoder(enc)(bufs)))
        assert torch.equal(bits(got.cpu()), bits(torch.from_numpy(cols[n])))


def test_lm_serving_engine_on_the_card(gpu):
    """The reduced qwen1.5-0.5b engine in f32 on the card: three bitpack and one
    rANS prompt decode on kernels 1 and 3 to their sources in one wave (two
    16-token prompts share a program), every request emits its tokens, the
    logits are finite, and a decode step after a 16-token prefill agrees with
    the same weights on the CPU (TF32 off) within 1e-3 of the largest logit."""
    import copy

    from repro_torch.configs import SMOKES
    from repro_torch.models import get_model
    from repro_torch.models.transformer import init_cache
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(SMOKES["qwen1.5-0.5b"], dtype=torch.float32)
    model = get_model(cfg).init(torch.Generator(gpu).manual_seed(0), gpu)
    eng = ServeEngine(cfg, model, batch_slots=2, max_len=128, eos=-1, device=gpu)
    rng = np.random.default_rng(0)
    src = {rid: rng.integers(0, cfg.vocab, n).astype(np.int32)
           for rid, n in ((0, 16), (1, 16), (2, 24), (3, 40))}
    finite = []
    decode = eng._decode

    def checked_decode(t):
        logits = decode(t)
        finite.append(bool(torch.isfinite(logits).all()))
        return logits

    eng._decode = checked_decode
    before = (FP.launches, NP.launches)
    for rid, toks in src.items():
        eng.submit_compressed(rid, encode(make_plan("ans" if rid == 3 else "bitpack"), toks),
                              max_new=4)
    eng.submit(Request(4, rng.integers(0, cfg.vocab, 8).astype(np.int32), max_new=4))
    done = eng.run_to_completion(200)
    assert FP.launches > before[0] and NP.launches > before[1]
    assert {k: len(v) for k, v in done.items()} == dict.fromkeys(range(5), 4)
    for req in eng._requests:
        assert req.error is None
        if req.rid in src:
            np.testing.assert_array_equal(req.prompt, src[req.rid])
    assert eng.decode_cache_stats["programs"] == 3 and eng.decode_cache_stats["hits"] == 1
    assert finite and all(finite)

    cpu = copy.deepcopy(model).to("cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 17)))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            outs = []
            for m, dev in ((model, gpu), (cpu, torch.device("cpu"))):
                t = toks.to(dev)
                _, st = m.prefill(t[:, :16], init_cache(cfg, 2, 32, device=dev))
                outs.append(m.decode_step(t[:, 16:], st)[0].cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    card, host = outs
    scale = float(host.abs().max())
    torch.testing.assert_close(card, host, rtol=1e-3, atol=1e-3 * scale)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "dbrx-132b", "qwen2-vl-2b",
                                  "rwkv6-7b", "zamba2-7b", "seamless-m4t-medium"])
def test_lm_family_on_the_card(arch, gpu):
    """A family's reduced config in f32 served on the card: a bitpack and an
    rANS prompt decode on kernels 1 and 3 to their sources, and every request
    gets the tokens the same weights give on the CPU (TF32 off)."""
    import copy

    from repro_torch.configs import SMOKES
    from repro_torch.models import get_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(SMOKES[arch], dtype=torch.float32)
    host = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    src = {0: rng.integers(0, cfg.vocab, 16).astype(np.int32),
           1: rng.integers(0, cfg.vocab, 24).astype(np.int32)}
    plain = rng.integers(0, cfg.vocab, 8).astype(np.int32)
    served, launched = {}, None
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev, model in ((gpu, copy.deepcopy(host).to(gpu)), ("cpu", host)):
            eng = ServeEngine(cfg, model, batch_slots=2, max_len=64, eos=-1, device=dev)
            before = (FP.launches, NP.launches)
            for rid, codec in ((0, "bitpack"), (1, "ans")):
                eng.submit_compressed(rid, encode(make_plan(codec), src[rid]), max_new=4)
            eng.submit(Request(2, plain, max_new=4))
            served[str(dev)] = eng.run_to_completion(100)
            launched = launched or (FP.launches > before[0], NP.launches > before[1])
            for req in eng._requests:
                assert req.error is None
                if req.rid in src:
                    np.testing.assert_array_equal(req.prompt, src[req.rid])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert launched == (True, True)
    assert served[str(gpu)] == served["cpu"]
    assert {k: len(v) for k, v in served["cpu"].items()} == dict.fromkeys(range(3), 4)


def test_kv_page_in_on_kernel_1(gpu):
    from repro_torch.serve.kvcache import page_in, page_out

    block = torch.randn((2, 256, 16, 64), generator=torch.Generator(gpu).manual_seed(1),
                        device=gpu).to(torch.bfloat16)
    pb = page_out(block)
    before = FP.launches
    got = page_in(pb, device=gpu)
    assert FP.launches > before
    launched = FP.launches
    plain = page_in(pb, device=gpu, backend="torch")
    assert FP.launches == launched
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), plain.view(torch.int16))
    assert pb.packed.nbytes < block.numel() * block.element_size() / 1.9


def test_token_loader_on_kernel_1(gpu):
    """qwen1.5-0.5b's 18-bit tokens of a (4, 256) batch unpacked on kernel 1,
    one launch, bitwise against the plain version and the host's tokens."""
    from repro_torch.data.loader import CompressedTokenLoader

    loader = CompressedTokenLoader(151936, 4, 256, device=gpu)
    host = loader.encode_host(7)
    bufs = loader.to_device(host)
    before = FP.launches
    got = loader.decode_fn()(bufs)
    assert FP.launches == before + 1
    plain = loader.decode_fn("torch")(bufs)
    assert FP.launches == before + 1
    torch.cuda.synchronize()
    want = torch.from_numpy(np.random.default_rng(7).integers(0, 151936, (4, 257),
                                                               dtype=np.int32))
    for k, w in (("tokens", want[:, :-1]), ("labels", want[:, 1:])):
        assert got[k].dtype == torch.int32 and got[k].device.type == "cuda"
        assert torch.equal(got[k], plain[k]) and torch.equal(got[k].cpu(), w)
    assert loader.bits == 18 and host["packed"].nbytes < want.numpy().nbytes / 1.7


def test_train_step_on_the_card(gpu):
    """Two steps of the reduced qwen1.5-0.5b's train step in f32 (remat
    "dots", AdamW with weight decay), its tokens unpacked on kernel 1: the
    losses, grad norms and every parameter within 1e-4 of the same weights'
    steps on the CPU (TF32 off; parameters as a share of the largest)."""
    import copy

    from repro_torch.configs import SMOKES
    from repro_torch.data.loader import CompressedTokenLoader
    from repro_torch.models import get_model
    from repro_torch.train import optimizer
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(SMOKES["qwen1.5-0.5b"], dtype=torch.float32)
    card = get_model(cfg).init(torch.Generator(gpu).manual_seed(0), gpu, train=True)
    host = copy.deepcopy(card).cpu()
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev, model in ((gpu, card), (torch.device("cpu"), host)):
            loader = CompressedTokenLoader(cfg.vocab, 4, 32, device=dev)
            decode = loader.decode_fn()
            step = make_train_step(cfg, opt_cfg, remat="dots")
            opt, hist = optimizer.init(model), []
            before = FP.launches
            for i in range(2):
                model, opt, m = step(model, opt, decode(loader.to_device(loader.encode_host(i))))
                hist.append((m["loss"].item(), m["grad_norm"].item()))
            assert FP.launches - before == (2 if dev.type == "cuda" else 0)
            out[dev.type] = hist, [p.detach().cpu() for p in model.parameters()]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (ch, cp), (hh, hp) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(np.array(ch), np.array(hh), rtol=1e-4)
    top = max(float(p.abs().max()) for p in hp)
    for a, b in zip(cp, hp):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * top)


def _counted_steps(cfg, dev):
    """The SMOKE model's decode step (2 slots, a 64-row cache half full) and
    train step (4 x 32, remat "dots", AdamW) on ``dev``, each a call."""
    from repro_torch.models import get_model
    from repro_torch.train import optimizer
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    api = get_model(cfg)
    gen = torch.Generator(dev).manual_seed(0) if dev.type != "meta" else None
    serve, train = api.init(gen, dev), api.init(gen, dev, train=True)
    cache = api.make_state(2, 64, device=dev)
    cache["len"] = 32
    tok = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    seq = torch.zeros((4, 33), dtype=torch.int32, device=dev)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    step = make_train_step(cfg, AdamWConfig(), remat="dots")
    opt = optimizer.init(train)
    return {"decode": lambda: api.decode_step(serve, tok, cache),
            "train": lambda: step(train, opt, batch)[2]}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("name", ["decode", "train"])
def test_op_cost_counts_the_card_as_meta(arch, name, gpu):
    """``op_cost.analyze`` of a step on the card counts the FLOPs, bytes and
    ops it counts on ``meta``: the dry run predicts the card's work."""
    from repro_torch.configs import SMOKES
    from repro_torch.roofline.op_cost import analyze

    card = analyze(_counted_steps(SMOKES[arch], gpu)[name])
    meta = analyze(_counted_steps(SMOKES[arch], torch.device("meta"))[name])
    assert card["by_op"] == meta["by_op"]
    assert (card["flops"], card["bytes"]) == (meta["flops"], meta["bytes"]) != (0, 0)


def _chip_smoke():
    import pathlib
    import sys

    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def test_placed_train_step_on_a_card_mesh(gpu):
    """qwen SMOKE's f32 training weights as DTensors on a 1 x 1 mesh over an
    NCCL group of one: ``chip_smoke.MESH_STEPS`` train steps bitwise the
    unplaced ones (phase 15 (b) at the SMOKE size)."""
    from repro_torch.configs import SMOKES

    rec = _chip_smoke().run_placed_train(SMOKES["qwen1.5-0.5b"], 0)
    assert rec["bitwise"] and len(rec["losses"]) == _chip_smoke().MESH_STEPS
    assert not torch.distributed.is_initialized()


def test_compressed_dp_step_two_ranks_on_one_card(gpu):
    """Two processes on ``cuda:0`` in a gloo group run the compressed
    data-parallel step on qwen SMOKE: parameters bitwise equal across the
    ranks, the synced gradients and error buffers bitwise the plain int8
    sum's, one kernel-1 unpack a step a rank (phase 15 (c) at the SMOKE
    size)."""
    cs = _chip_smoke()
    rec = cs.run_dp_compressed("qwen1.5-0.5b", 0, smoke=True)
    assert rec["launches_per_rank"] == [cs.MESH_STEPS] * cs.DP_RANKS


# ------------------------------------------------------------ the mesh's executor

@pytest.mark.parametrize("concurrent", [False, True])
def test_sharded_run_on_the_card(concurrent, gpu):
    """``run_sharded`` of an N = 4 plan with ``shard_threshold_bytes=0``,
    every logical device on this card with its own streams, bitwise the
    single-device run: kernels 2 and 3 decode spans that start inside a
    column into shard-sized outputs (the group-span columns of
    ``tests/test_torch_mesh_run.py``)."""
    import torch_mesh_ranks as R
    from repro_torch.core import plan as P

    cols, plans = R.mesh_columns(P)
    pipe = ColumnPipeline(plans, device=gpu, chunk_bytes="auto", chunk_decode=True, mesh=4)
    pipe.compress(cols)
    single = pipe.run()
    mp = pipe.mesh_plan(shard_threshold_bytes=0)
    assert {"big", "rle", "sdbp"} <= set(mp.shards)
    before = (GP.launches, NP.launches)
    res = pipe.run_sharded(plan=mp, concurrent=concurrent)
    assert GP.launches > before[0] and NP.launches > before[1]
    for n, a in cols.items():
        assert torch.equal(res[n].array, single[n].array), n
        assert torch.equal(res[n].array.cpu(), torch.from_numpy(a)), n
    assert pipe.executor.physical_devices()[0] == gpu and res.makespan_s > 0
    assert all(len(set(res[c].shard_devices)) > 1 for c in mp.shards)
    assert [t.name for t in threading.enumerate() if t.name.startswith("zipflow-")] == []
