#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--scale S] [--seed N] [--out FILE.json]

Phases, in order; none catches its own failure, so any error or mismatch exits
non-zero before the final line:

  1. fail unless CUDA is available;
  2. build the three hand-written kernels from ``src/repro_torch/kernels/csrc``
     (``nvcc``, ``sm_90a``, one process per source, all at once), then generate
     TPC-H at ``--scale`` (default SF 1) and encode all 24 Table-2 columns
     (set-up);
  3. kernel vs plain PyTorch version on the card, bitwise: every Fully-Parallel,
     Group-Parallel and Non-Parallel stage of the 24 columns' main path (the FP
     producers inside rule-5 Aux stages included) on the same inputs, timed
     beside their plain versions (the plain rANS decode, a Python loop of
     ``chunk_size`` steps, with fewer reps) and, for RLE expansion,
     ``torch.repeat_interleave`` (for byte-reassemble, the bytes viewed as
     32-bit words and cloned); each launch also by ``torch.profiler``, and
     kernel 3 at blocks of 32 and 64 threads; an FP bit-width x length sweep;
     kernel 1 at every bit width 0-32 around its tile, on packed buffers cut
     short (the clamp) at every 16-byte misalignment, at bit widths above 32
     (its per-element path), on uint8 and uint16 gathers, on gathers from a
     large table, from a uint8 table at an odd address and behind another
     transform, on BYTES items of 1-5 bytes, and on LOAD -> SPAN and UNPACK ->
     GATHER -> UNZIGZAG; GP on skewed run lengths, on zero-count groups
     whose window overflows a block's shared buffer, on all counts 1, on one
     run longer than many tiles and on StringDict words longer than a
     thread's 16 bytes; an rANS sweep (chunk sizes 256, 1000 and 4096; uint8,
     int32 and float32 items; a skewed, a one-symbol and a uniform 256-symbol
     alphabet; lengths that are not a multiple of the chunk size; a rule-4
     tail; tables outside the packed layout);
  4. the main path: ``ColumnPipeline(..., device="cuda").run()`` once cold and
     ``WARM_RUNS`` times warm, with the launch counts zeroed just before; every
     column must equal its source bitwise.  Then the same blobs through the
     plain backend, and one more warm run under ``torch.profiler`` for the
     device's busy time by kind;
  5. report: per-column lines, a totals line, the ``{"kernels": [...]}`` line,
     the card's name and power limit from ``nvidia-smi``, and last
     ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNELS = {
    "fully_parallel": ("src/repro_torch/kernels/csrc/fully_parallel.cu",
                       "src/repro/kernels/fully_parallel.py:35"),
    "group_parallel": ("src/repro_torch/kernels/csrc/group_parallel.cu",
                       "src/repro/kernels/group_parallel.py:51"),
    "non_parallel": ("src/repro_torch/kernels/csrc/non_parallel.cu",
                     "src/repro/kernels/non_parallel.py:29"),
}
FP_BWS = (1, 3, 7, 8, 13, 17, 25, 31, 32)
FP_NS = (1, 127, 4097, 1 << 20, 1_000_003)
NP_CHUNKS = (256, 1000, 4096)     # 1000: chunks that are not a multiple of 16
NP_KINDS = ("uint8", "int32", "float32", "skewed", "one-symbol", "uniform256")
NP_BLOCKS = (32, 64)              # kernel 3's block sizes timed on the main path
NP_NS = (1, 3 * 4096, 1_000_003)
WARM_RUNS = 5
# operations bound of the rANS decode: integer operations per symbol (mask,
# shift, multiply, add, subtract, compare, renorm shift/or, three table reads,
# the store) over the H100 SXM's peak INT32 rate outside the tensor cores
# (33.5 TOP/s, Hopper architecture white paper)
NP_OPS_PER_SYMBOL = 12
INT32_OPS_PER_S = 33.5e12


def bits(t: torch.Tensor) -> torch.Tensor:
    """4-byte values as int32 bits (torch compares few uint32 ops)."""
    return t.view(torch.int32) if t.dtype in (torch.float32, torch.uint32) else t


def same(k: torch.Tensor, p: torch.Tensor, what: str) -> float:
    """Bitwise equality of kernel and plain outputs; returns the max abs error (0)."""
    if k.dtype != p.dtype or k.shape != p.shape:
        raise AssertionError(f"{what}: kernel gives {k.dtype}{tuple(k.shape)}, "
                             f"plain {p.dtype}{tuple(p.shape)}")
    if not torch.equal(bits(k), bits(p)):
        err = (k.double() - p.double()).abs().max().item()
        raise AssertionError(f"{what}: kernel differs from plain, max abs err {err}")
    return 0.0


class Timer:
    """Median device time of a call, CUDA events, L2 flushed before each rep.

    The flush (zeroing 1 GiB, ~0.4 ms of device time) also keeps the device
    busy while the host prepares the launch, so the events time the device's
    work, not the host's argument packing."""

    def __init__(self, reps: int = 10):
        self.reps = reps
        self.flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int | None = None) -> float:
        fn()
        ts = []
        for _ in range(reps or self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))


def stage_bytes(names, env, out: torch.Tensor) -> int:
    """Bytes a stage must move: each input read once, the output written once."""
    return (sum(env[k].numel() * env[k].element_size() for k in set(names))
            + out.numel() * out.element_size())


def ans_input(kind: str, n: int, rng) -> np.ndarray:
    """One input of the rANS sweep."""
    if kind == "skewed":
        return np.where(rng.random(n) < 0.995, 78, rng.integers(0, 256, n)) \
            .astype(np.uint8)
    if kind == "one-symbol":
        return np.full(n, 82, np.uint8)
    if kind == "float32":
        return rng.normal(0, 1e3, n).astype(np.float32)
    if kind == "int32":
        return rng.integers(-2**31, 2**31, n).astype(np.int32)
    if kind == "uniform256":                # renormalises about every 2 steps
        return rng.integers(0, 256, n).astype(np.uint8)
    return rng.integers(0, 5, n).astype(np.uint8)


def long_words(n_words: int, rng) -> np.ndarray:
    """Text whose words (17-64 letters) are longer than a thread's 16 bytes."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    lens = rng.integers(17, 65, n_words)
    text = rng.choice(letters, int(lens.sum()) + n_words)
    text[np.cumsum(lens + 1) - 1] = ord(" ")
    return text.astype(np.uint8)


def profiled_ms(calls, flush: torch.Tensor, reps: int = 5) -> list[float]:
    """Median device time of each ``(fn, kernel)`` of ``calls`` over ``reps``
    calls of fn, as ``torch.profiler`` reads it (no launch latency, unlike CUDA
    events).  All of them run under one profiler session (a process's later
    sessions can miss the card's events), and a kernel's launches are matched
    to the calls in launch order, so each fn must launch its kernel once."""
    for fn, _ in calls:
        fn()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for fn, _ in calls:
            for _ in range(reps):
                flush.zero_()
                fn()
        torch.cuda.synchronize()
    gpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = {k: [e.time_range.elapsed_us() / 1e3
                for e in sorted((e for e in gpu if k in e.name),
                                key=lambda e: e.time_range.start)]
            for k in {k for _, k in calls}}
    out = []
    for fn, k in calls:
        ts, seen[k] = seen[k][:reps], seen[k][reps:]
        if len(ts) != reps:
            raise AssertionError(f"profiler missed launches of {k}")
        out.append(float(np.median(ts)))
    if any(seen.values()):
        raise AssertionError("profiler saw more launches than were made")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0, help="TPC-H scale factor")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the per-stage and per-column records here")
    args = ap.parse_args()

    # ---------------------------------------------------------------- phase 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.compiler import build_graph, device_buffers
    from repro_torch.core.executor import StreamingExecutor
    from repro_torch.core.geometry import Geometry, chip_from_device, native_config
    from repro_torch.core.fusion import fuse
    from repro_torch.algos.bitpack import pack_np
    from repro_torch.core.patterns import (AFFINE, BYTES, IDENTITY, LOAD, STRGATHER,
                                           Aux, BufSpec, FullyParallel, GroupParallel,
                                           NonParallel, gather, load, load_bytes, span,
                                           stage_inputs, unpack, unzigzag)
    from repro_torch.core.plan import Encoded, Plan, encode, make_plan
    from repro_torch.data.columns import TABLE2_PLANS
    from repro_torch.data.loader import ColumnPipeline
    from repro_torch.data.tpch import generate
    from repro_torch.kernels import cuda, ref
    from repro_torch.kernels.fully_parallel import KERNEL as FP, fully_parallel
    from repro_torch.kernels.group_parallel import (KERNEL as GP, group_parallel,
                                                    tile_windows)
    from repro_torch.kernels.non_parallel import KERNEL as NP, decode_table, non_parallel
    from repro_torch.kernels.ops import run_stage

    columns = tuple(TABLE2_PLANS)
    libs = (FP, GP, NP)

    name = torch.cuda.get_device_name(0)
    spec = chip_from_device(0)
    hbm = spec.hbm_gbps
    print(f"device: {name}  torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"sms {spec.sms}  l2_mb {spec.l2_bytes / 2**20:.0f}  hbm_bound_gbps {hbm} "
          f"({spec.source})")

    # ---------------------------------------------------------------- phase 2
    t0 = time.perf_counter()
    cuda.build(libs)
    for lib in libs:
        lib.load()
    built = " ".join(f"{lib.name} {lib.build_s:.1f} s" for lib in libs
                     if lib.build_s is not None)
    print(f"build: {time.perf_counter() - t0:.2f} s ({built or 'cached'}) -> "
          f"{FP.path().parent}")
    for lib in libs:
        for line in lib.path().with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib.name}: {line.strip()}")

    t0 = time.perf_counter()
    cols = generate(args.scale, seed=args.seed)
    cols = {k: cols[k] for k in columns}
    t_gen = time.perf_counter() - t0
    pipe = ColumnPipeline(dict(TABLE2_PLANS), device="cuda")
    t0 = time.perf_counter()
    ratios = pipe.compress(cols)
    print(f"setup: generate(scale={args.scale}) {t_gen:.1f} s, encode "
          f"{time.perf_counter() - t0:.1f} s, programs {pipe.cache_stats}")

    # ---------------------------------------------------------------- phase 3
    timer = Timer()
    err = {k: 0.0 for k in KERNELS}
    compared = {k: 0 for k in KERNELS}
    stages = []
    profiled = []   # (record, fn, kernel) of each timed stage, profiled at once

    def check(st, env, col, timed):
        """Kernel vs plain on one FP/GP/NP stage; env holds plain-version inputs."""
        plain_reps = None
        if isinstance(st, FullyParallel):
            kname, kfn, pfn = "fully_parallel", fully_parallel, ref.fully_parallel_torch
        elif isinstance(st, GroupParallel):
            kname, kfn, pfn = "group_parallel", group_parallel, ref.group_parallel_torch
        else:
            kname, kfn, pfn = "non_parallel", non_parallel, ref.non_parallel_torch
            # the plain rANS decode is chunk_size steps of a dozen torch
            # launches each (about a second at 4096): 3 reps, not 10
            plain_reps = 3
            if timed and not decode_table(env[st.sym_tab], env[st.freq_tab],
                                          env[st.cum_tab])[1]:
                raise AssertionError(f"{col}:{st.name}: tables miss the packed layout")
        plain = pfn(st, env)
        err[kname] = max(err[kname], same(kfn(st, env), plain, f"{col}:{st.name}"))
        compared[kname] += 1
        if timed:
            rec = {"kernel": kname, "column": col, "stage": st.name, "n": st.n_out,
                   "bytes": stage_bytes(stage_inputs(st), env, plain),
                   "ms": timer.ms(lambda: kfn(st, env)),
                   "plain_ms": timer.ms(lambda: pfn(st, env), plain_reps),
                   "library_ms": None}
            profiled.append((rec, lambda: kfn(st, env), f"zf_{kname}"))
            if kname == "non_parallel":
                for s_ in NP_BLOCKS:
                    rec[f"ms_s{s_}"] = timer.ms(lambda: kfn(st, env, Geometry(1, s_, 1)))
            rec["bound_ms"] = rec["bytes"] / (hbm * 1e9) * 1e3
            rec["bound_by"] = "bytes"
            if kname == "non_parallel":
                ops_ms = st.n_out * NP_OPS_PER_SYMBOL / INT32_OPS_PER_S * 1e3
                if ops_ms > rec["bound_ms"]:
                    rec["bound_ms"], rec["bound_by"] = ops_ms, "operations"
            if (isinstance(st, GroupParallel) and st.map_kind == IDENTITY
                    and not st.tail and st.values[0][0].kind == LOAD):
                vals = env[st.values[0][0].bufs[0]]
                counts = torch.diff(env[st.presum]).long()
                rec["library_ms"] = timer.ms(
                    lambda: torch.repeat_interleave(vals, counts,
                                                    output_size=st.n_out))
                same(torch.repeat_interleave(vals, counts, output_size=st.n_out)
                     .to(plain.dtype), plain, f"{col}:{st.name} repeat_interleave")
            if (isinstance(st, FullyParallel) and len(st.chain) == 1
                    and st.chain[0].kind == BYTES and st.chain[0].imm == 4
                    and plain.element_size() == 4):
                raw = env[st.chain[0].bufs[0]][:4 * st.n_out]
                rec["library_ms"] = timer.ms(lambda: raw.view(torch.int32).clone())
                same(raw.view(torch.int32).clone().view(plain.dtype), plain,
                     f"{col}:{st.name} view-and-clone")
            stages.append(rec)
        return plain

    def walk(graph, env, col, timed=True):
        for st in graph.stages:
            if isinstance(st, Aux):
                local = dict(env)
                for prod in st.producers:
                    local[prod.out] = check(prod, local, col, timed)
                env[st.out] = run_stage(st, env, "torch")
            else:
                env[st.out] = check(st, env, col, timed)
        return env[graph.out]

    t0 = time.perf_counter()
    for col in columns:
        walk(pipe.executor.graph(col), device_buffers(pipe.encoded(col)), col)
    for (rec, _, _), ms in zip(profiled, profiled_ms([c[1:] for c in profiled],
                                                      timer.flush)):
        rec["profiler_ms"] = ms
    profiled = None
    rng = np.random.default_rng(args.seed)
    for bw in FP_BWS:
        for n in FP_NS:
            lo, hi = (-2**31, 2**31) if bw == 32 else (0, 1 << bw)
            arr = rng.integers(lo, hi, n).astype(np.int32)
            enc = encode(Plan("bitpack", params={"bit_width": bw}), arr)
            out = walk(build_graph(enc), device_buffers(enc), f"sweep bw={bw} n={n}",
                       timed=False)
            same(out.cpu(), torch.from_numpy(arr), f"sweep bw={bw} n={n} vs source")
    # kernel 1's paths, each case counted on the compare line
    fp_tile = native_config("fp").tile
    fp_cases: dict[str, int] = {}

    def fp_case(label, chain, inputs, env, n, out_dtype=np.int32):
        st = FullyParallel(chain=chain, inputs=inputs,
                           specs=tuple(BufSpec("full") for _ in inputs), out="o",
                           n_out=n, out_dtype=out_dtype, elementwise=False, name=label)
        fp_cases[label] = fp_cases.get(label, 0) + 1
        return check(st, env, f"fp {label}", False)

    def packed(bw, n, cut=0, offset=0):
        """Bit-packed values of bw bits, ``cut`` words dropped from the end, the
        buffer ``offset`` words into its allocation; the env and the values."""
        vals = rng.integers(0, 1 << bw, n, dtype=np.int64) if bw else np.zeros(n, np.int64)
        words = (pack_np(vals, bw) if bw else np.zeros(2, np.uint32))
        words = words[:max(1, words.size - cut)].view(np.int32)
        buf = torch.from_numpy(np.concatenate([np.zeros(offset, np.int32), words])).cuda()
        base = int(rng.integers(-2**31, 2**31))
        env = {"p": buf[offset:], "bw": torch.tensor([bw], dtype=torch.int32).cuda(),
               "base": torch.tensor([base], dtype=torch.int32).cuda()}
        return env, (vals + base + 2**31) % 2**32 - 2**31

    unp, unp_in = (unpack("p", "bw", "base"),), ("p", "bw", "base")
    for bw in range(33):
        for n in (1, 31, 32, 127, 128, fp_tile - 1, fp_tile, fp_tile + 1, 1_000_003):
            env, want = packed(bw, n)
            got = fp_case("bw 0-32", unp, unp_in, env, n)
            if not np.array_equal(got.cpu().numpy().astype(np.int64), want):
                raise AssertionError(f"fp bw={bw} n={n}: plain differs from the source")
    for bw in (1, 7, 13, 31, 32):
        for n in (127, fp_tile + 1, 2 * fp_tile + 5):
            for cut in (1, 2, 9, 10**9):          # the guard word, then more
                for offset in range(4):           # every 16-byte misalignment
                    fp_case("short buffer", unp, unp_in, packed(bw, n, cut, offset)[0], n)
    for bw in (33, 40, 64, 100):
        env = packed(31, 300_001)[0]
        env["bw"] = torch.tensor([bw], dtype=torch.int32).cuda()
        fp_case("bw > 32", unp, unp_in, env, 300_001)
    n = 1_000_003
    env = packed(9, n)[0]
    env["x"] = torch.from_numpy(rng.integers(-5, 600, n).astype(np.int16)).cuda()
    for dt in (np.uint8, np.uint16):
        env["t"] = torch.from_numpy(rng.integers(0, np.iinfo(dt).max + 1, 513)
                                    .astype(dt)).cuda()
        fp_case(f"{np.dtype(dt).name} gather", unp + (gather("t"),), unp_in + ("t",),
                env, n, dt)
        fp_case(f"{np.dtype(dt).name} gather", (load("x"), gather("t")), ("x", "t"),
                env, n, dt)
    raw = torch.from_numpy(rng.integers(0, 256, 5 * 300_007 + 8).astype(np.uint8)).cuda()
    for itemsize in range(1, 6):
        for offset in range(4):
            for m in (1, 31, 300_007):
                for dt in ((np.int32, np.uint32, np.float32) if itemsize == 4
                           else (np.int32,)):
                    fp_case("bytes 1-5", (load_bytes("b", itemsize),), ("b",),
                            {"b": raw[offset:offset + m * itemsize]}, m, dt)
    env["t"] = torch.from_numpy(rng.integers(-2**31, 2**31, 2048).astype(np.int32)).cuda()
    env["offs"] = torch.from_numpy(np.sort(rng.integers(0, 10**7, 5000))
                                   .astype(np.int32)).cuda()
    fp_case("unpack-gather-unzigzag", unp + (gather("t"), unzigzag()), unp_in + ("t",),
            env, n)
    raw8 = torch.from_numpy(rng.integers(0, 256, 4000).astype(np.uint8)).cuda()
    env["big"] = torch.from_numpy(rng.integers(-2**31, 2**31, 5000).astype(np.int32)).cuda()
    env["u8"] = raw8[3:3 + 1001]              # odd address, not whole words
    for chain in ((gather("big"),), (gather("u8"),), (unzigzag(), gather("t")),
                  (gather("big"), unzigzag(), gather("t"))):
        ins = tuple(dict.fromkeys(b for op in chain for b in op.bufs))
        fp_case("tables", unp + chain, unp_in + ins, env, n,
                np.uint8 if chain[-1].bufs == ("u8",) else np.int32)
    for dt in (np.int32, np.int16, np.int8, np.uint8):
        info = np.iinfo(dt)
        env["x"] = torch.from_numpy(rng.integers(max(info.min, -50), min(info.max, 6000),
                                                 n).astype(dt)).cuda()
        fp_case("load-span", (load("x"), span("offs")), ("x", "offs"), env, n)
    counts = np.where(rng.random(200_000) < 0.01, rng.integers(2, 300, 200_000), 1)
    counts[1234] = 3_000_000                      # one run far longer than a tile
    vals = rng.integers(-2**31, 2**31 - 1, counts.size).astype(np.int32)
    skew = np.repeat(vals, counts).astype(np.int32)
    for plan in (Plan("rle", children={"counts": make_plan("bitpack"),
                                       "values": make_plan("bitpack")}),
                 Plan("rle", children={"counts": make_plan("bitpack")})):
        enc = encode(plan, skew)
        out = walk(build_graph(enc), device_buffers(enc), f"skew {plan.describe()}",
                   timed=False)
        same(out.cpu(), torch.from_numpy(skew), f"skew {plan.describe()} vs source")
    # DeltaStride whose affine map wraps past 2^31 inside a long group
    ds = Encoded("deltastride",
                 {"n_groups": 3, "group_presum": np.array([0, 1, 400_001, 400_003])},
                 {"starts": np.array([5, 2**31 - 1000, -7], np.int32),
                  "strides": np.array([0, 7, -2**31], np.int32),
                  "counts": np.array([1, 400_000, 2], np.int32)}, {}, 400_003,
                 np.dtype(np.int32))
    out = walk(build_graph(ds), device_buffers(ds), "deltastride wrap", timed=False)
    want = np.concatenate([[5], (np.int64(2**31 - 1000) + 7 * np.arange(400_000)),
                           [-7, -7 - 2**31]]).astype(np.int64)
    same(out.cpu(), torch.from_numpy(((want + 2**31) % 2**32 - 2**31).astype(np.int32)),
         "deltastride wrap vs source")
    # kernel 2's windows: zero-count groups whose window overflows a tile's
    # shared buffer (the kernel's global-memory path), all counts 1 (a window
    # of exactly T groups), one run longer than many tiles; each through the
    # IDENTITY, AFFINE and STRGATHER maps
    gp_geom = native_config("gp")
    tile = gp_geom.S * gp_geom.C            # outputs of one sub-tile's window
    zero = rng.integers(1, 4, 400_000)
    zero[rng.random(zero.size) < 0.3] = 0
    zero[100_000:200_000] = 0
    gp_cases = {"zero-counts": (zero, lambda m: int(m.max()) > tile),
                "all-ones": (np.ones(1_000_003, np.int64), lambda m: int(m.max()) == tile),
                "long-run": (np.concatenate([rng.integers(1, 5, 3000), [50 * tile],
                                             rng.integers(1, 5, 3000)]),
                             lambda m: int((m == 1).sum()) >= 48)}
    for label, (cnt, shows) in gp_cases.items():
        presum = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
        env = {"presum": torch.from_numpy(presum).cuda()}
        for k in ("vals", "strides"):
            env[k] = torch.from_numpy(rng.integers(-2**31, 2**31, cnt.size)
                                      .astype(np.int32)).cuda()
        windows = tile_windows(env["presum"], int(presum[-1]), tile)
        if not shows(windows):
            raise AssertionError(f"gp {label}: windows {windows.min()}..{windows.max()} "
                                 f"do not show the case (tile {tile})")
        env["words"] = torch.from_numpy(rng.integers(0, 1000, cnt.size)
                                        .astype(np.int32)).cuda()
        env["chars"] = torch.from_numpy(rng.integers(0, 256, 50_000)
                                        .astype(np.uint8)).cuda()
        env["offs"] = torch.from_numpy(np.sort(rng.integers(0, 49_000, 1001))
                                       .astype(np.int32)).cuda()
        for map_kind, names in ((IDENTITY, ("vals",)), (AFFINE, ("vals", "strides")),
                                (STRGATHER, ("words",))):
            extra = ("chars", "offs") if map_kind == STRGATHER else ()
            st = GroupParallel(presum="presum", value_inputs=names,
                               value_specs=(BufSpec("tile"),) * len(names),
                               values=tuple((load(k),) for k in names),
                               map_kind=map_kind, extra_inputs=extra, out="out",
                               n_out=int(presum[-1]), n_groups=cnt.size,
                               out_dtype=np.uint8 if extra else np.int32,
                               name=f"{label} {map_kind}")
            got = check(st, env, f"gp {label}", False)
            if map_kind == IDENTITY:
                same(got.cpu(), torch.from_numpy(np.repeat(env["vals"].cpu().numpy(), cnt)),
                     f"gp {label} vs numpy.repeat")
    text = long_words(200_000, rng)
    enc = encode(make_plan("stringdict"), text)
    out = walk(build_graph(enc), device_buffers(enc), "stringdict long words", timed=False)
    same(out.cpu(), torch.from_numpy(text), "stringdict long words vs source")
    for chunk in NP_CHUNKS:
        for kind in NP_KINDS:
            for n in NP_NS:
                arr = ans_input(kind, n, rng)
                enc = encode(Plan("ans", params={"chunk_size": chunk}), arr)
                what = f"ans sweep {kind} chunk={chunk} n={n}"
                out = walk(build_graph(enc), device_buffers(enc), what, timed=False)
                same(bits(out.cpu()), bits(torch.from_numpy(arr)), f"{what} vs source")
    # fusion rule 4 (no Table-2 plan fires it): a GATHER tail inside kernel 3
    syms = rng.integers(0, 40, 1_000_003).astype(np.uint8)
    enc = encode(Plan("ans", params={"chunk_size": 4096}), syms)
    env = device_buffers(enc)
    table = rng.integers(-2**31, 2**31, 40).astype(np.int32)
    env["table"] = torch.from_numpy(table).cuda()
    (dec,) = build_graph(enc).stages
    dec.out = "syms"
    (fused,) = fuse([dec, FullyParallel(
        chain=(load("syms"), gather("table")), inputs=("syms",),
        specs=(BufSpec("tile"),), out="out", n_out=syms.size, name="lookup")])
    if not isinstance(fused, NonParallel) or not fused.tail:
        raise AssertionError(f"rule 4 did not fuse: {fused}")
    same(check(fused, env, "rule-4 tail", False).cpu(), torch.from_numpy(table[syms]),
         "rule-4 tail vs source")
    # tables outside the packed layout (no encoder makes them) take kernel 3's
    # three-table path; the output is garbage, the same in both versions
    enc = encode(Plan("ans", params={"chunk_size": 1000}), ans_input("uint8", 100_003, rng))
    env = device_buffers(enc)
    (dec,) = build_graph(enc).stages
    cum = env[dec.cum_tab].to(torch.int32).cpu().numpy()
    cum[int(np.argmax(env[dec.freq_tab].to(torch.int32).cpu().numpy() > 3))] += 3
    env[dec.cum_tab] = torch.from_numpy(cum.astype(np.uint16)).cuda()
    if decode_table(env[dec.sym_tab], env[dec.freq_tab], env[dec.cum_tab])[1]:
        raise AssertionError("the altered tables still fit the packed layout")
    check(dec, env, "ans three-table path", False)
    print(f"compare: {compared} kernel launches bitwise equal to plain, of them "
          f"kernel-1 cases {fp_cases} ({time.perf_counter() - t0:.1f} s)")
    for r in stages:
        lib = "" if r["library_ms"] is None else f" library_ms {r['library_ms']:.4f}"
        lib += "".join(f" {k} {r[k]:.4f}" for k in ("profiler_ms",) + tuple(
            f"ms_s{s_}" for s_ in NP_BLOCKS) if k in r)
        print(f"stage {r['kernel']:14s} {r['column']:16s} {r['stage']:28s} n {r['n']:9d} "
              f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.4f}{lib}")

    # ---------------------------------------------------------------- phase 4
    for lib in libs:
        lib.launches = 0
    makespans, host_ms = [], []
    for label in ("cold",) + ("warm",) * WARM_RUNS:
        res = None      # drop the last run's columns: a warm run reuses their memory
        t0 = time.perf_counter()
        res = pipe.run()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        for col in columns:
            got = res[col].array.cpu()
            same(got, torch.from_numpy(cols[col]), f"{label} run {col} vs source")
        makespans.append(pipe.makespan_s)
    launches = {k: lib.launches for k, lib in zip(KERNELS, libs)}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not run on the main path: {launches}")
    plain_exec = StreamingExecutor(backend="torch", device=pipe.device)
    for col in columns:
        plain_exec.compile(col, pipe.encoded(col))
    for _ in range(2):
        pres = plain_exec.run()
    for col in columns:
        same(pres[col].array.cpu(), torch.from_numpy(cols[col]), f"plain run {col}")
    pres = None
    for r in res.values():
        r.array = None  # keep the records, free the columns before the traced run
    # one more warm run under the profiler: where the device's time goes
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced = pipe.run()
    device_ms = {"h2d_copy": 0.0, **{k: 0.0 for k in KERNELS}, "torch_ops": 0.0}
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = ("h2d_copy" if "Memcpy" in e.name else
                "fully_parallel" if "zf_fully_parallel" in e.name else
                "group_parallel" if "zf_group_parallel" in e.name else
                "non_parallel" if "zf_non_parallel" in e.name else "torch_ops")
        device_ms[kind] += e.time_range.elapsed_us() / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, reach = 0.0, float("-inf")
    for a, b in sorted(spans):          # union of device intervals
        busy_us += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    traced_ms = pipe.makespan_s * 1e3
    if sum(device_ms.values()) <= 0:
        raise AssertionError("the profiled run shows no device work")
    print("device " + " ".join(f"{k}_ms {v:.4f}" for k, v in device_ms.items())
          + f" busy_ms {busy_us / 1e3:.4f} traced_makespan_ms {traced_ms:.4f} "
          f"busy_share {busy_us / 1e3 / traced_ms:.4f}")
    traced = None

    # ---------------------------------------------------------------- phase 5
    makespan = float(np.median(makespans[1:]))
    plain_b = sum(r.plain_bytes for r in res.values())
    comp_b = sum(r.compressed_bytes for r in res.values())
    rows = []
    for col in columns:
        r = res[col]
        rows.append({"column": col, "nesting": pipe.executor.graph(col).nesting,
                     "rows": int(cols[col].size), "compressed_mb": r.compressed_bytes / 1e6,
                     "ratio": ratios[col], "transfer_ms": r.transfer_s * 1e3,
                     "decode_ms": r.decode_s * 1e3, "launches": r.kernel_launches})
        print(f"column {col:16s} {rows[-1]['nesting']:60s} rows {cols[col].size:9d} "
              f"comp_mb {rows[-1]['compressed_mb']:.3f} ratio {ratios[col]:.2f} "
              f"transfer_ms {rows[-1]['transfer_ms']:.4f} decode_ms "
              f"{rows[-1]['decode_ms']:.4f} launches {r.kernel_launches}")
    totals = {"sf": args.scale, "warm_runs": WARM_RUNS, "plain_mb": plain_b / 1e6, "compressed_mb": comp_b / 1e6,
              "makespan_ms_cold": makespans[0] * 1e3, "makespan_ms": makespan * 1e3,
              "makespan_ms_warm_min": min(makespans[1:]) * 1e3,
              "makespan_ms_warm_max": max(makespans[1:]) * 1e3,
              "host_run_ms": float(np.median(host_ms[1:])),
              "plain_backend_makespan_ms": plain_exec.last_makespan_s * 1e3,
              "effective_plain_gbps": plain_b / makespan / 1e9}
    print("totals " + " ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                               for k, v in totals.items()))
    entries = []
    for kname, (source, replaces) in KERNELS.items():
        mine = [r for r in stages if r["kernel"] == kname]
        big = max(mine, key=lambda r: (r["library_ms"] is not None, r["bytes"]))
        entries.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": err[kname],
            "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": big["library_ms"],
            "matches_plain": True, "at": f"{big['column']}:{big['stage']}",
            "n": big["n"], "launches_per_run": launches[kname] // len(makespans),
            "main_path_ms": sum(r["ms"] for r in mine),
            "main_path_plain_ms": sum(r["plain_ms"] for r in mine),
            "main_path_bound_ms": sum(r["bound_ms"] for r in mine),
            "main_path_profiler_ms": sum(r["profiler_ms"] for r in mine)})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": name, "stages": stages,
                                        "columns": rows, "totals": totals,
                                        "kernels": entries}, indent=1))
    print(json.dumps({"kernels": entries}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
