#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--scale S] [--seed N] [--out FILE.json]

Phases, in order; none catches its own failure, so any error or mismatch exits
non-zero before the final line:

  1. fail unless CUDA is available;
  2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``
     (``nvcc``, ``sm_90a``), then generate TPC-H at ``--scale`` (default SF 1)
     and encode the 22 columns the port decodes (set-up);
  3. kernel vs plain PyTorch version on the card, bitwise: every Fully-Parallel
     and Group-Parallel stage of the 22 columns' main path (the FP producers
     inside rule-5 Aux stages included) on the same inputs, timed beside their
     plain versions and, for RLE expansion, ``torch.repeat_interleave``; an FP
     bit-width x length sweep; GP on skewed run lengths;
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
}
FP_BWS = (1, 3, 7, 8, 13, 17, 25, 31, 32)
FP_NS = (1, 127, 4097, 1 << 20, 1_000_003)
WARM_RUNS = 5


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


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

    def ms(self, fn) -> float:
        fn()
        ts = []
        for _ in range(self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))


def stage_bytes(names, env, n_out: int) -> int:
    """Bytes a stage must move: each input read once, the output written once."""
    return sum(env[k].numel() * env[k].element_size() for k in set(names)) + 4 * n_out


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
    from repro_torch.core.geometry import chip_from_device
    from repro_torch.core.patterns import (IDENTITY, LOAD, Aux, FullyParallel,
                                           GroupParallel, stage_inputs)
    from repro_torch.core.plan import Encoded, Plan, encode, make_plan
    from repro_torch.data.columns import SLICE_COLUMNS, TABLE2_PLANS
    from repro_torch.data.loader import ColumnPipeline
    from repro_torch.data.tpch import generate
    from repro_torch.kernels import cuda, ref
    from repro_torch.kernels.fully_parallel import KERNEL as FP, fully_parallel
    from repro_torch.kernels.group_parallel import KERNEL as GP, group_parallel
    from repro_torch.kernels.ops import run_stage

    name = torch.cuda.get_device_name(0)
    spec = chip_from_device(0)
    hbm = spec.hbm_gbps
    print(f"device: {name}  torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"sms {spec.sms}  l2_mb {spec.l2_bytes / 2**20:.0f}  hbm_bound_gbps {hbm} "
          f"({spec.source})")

    # ---------------------------------------------------------------- phase 2
    t0 = time.perf_counter()
    cuda.build([FP, GP])
    FP.load()
    GP.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {FP.path().parent}")
    for lib in (FP, GP):
        for line in lib.path().with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib.name}: {line.strip()}")

    t0 = time.perf_counter()
    cols = generate(args.scale, seed=args.seed)
    cols = {k: cols[k] for k in SLICE_COLUMNS}
    t_gen = time.perf_counter() - t0
    pipe = ColumnPipeline({k: TABLE2_PLANS[k] for k in SLICE_COLUMNS}, device="cuda")
    t0 = time.perf_counter()
    ratios = pipe.compress(cols)
    print(f"setup: generate(scale={args.scale}) {t_gen:.1f} s, encode "
          f"{time.perf_counter() - t0:.1f} s, programs {pipe.cache_stats}")

    # ---------------------------------------------------------------- phase 3
    timer = Timer()
    err = {"fully_parallel": 0.0, "group_parallel": 0.0}
    compared = {"fully_parallel": 0, "group_parallel": 0}
    stages = []

    def check(st, env, col, timed):
        """Kernel vs plain on one FP/GP stage; env holds plain-version inputs."""
        if isinstance(st, FullyParallel):
            kname, kfn, pfn = "fully_parallel", fully_parallel, ref.fully_parallel_torch
        else:
            kname, kfn, pfn = "group_parallel", group_parallel, ref.group_parallel_torch
        plain = pfn(st, env)
        err[kname] = max(err[kname], same(kfn(st, env), plain, f"{col}:{st.name}"))
        compared[kname] += 1
        if timed:
            rec = {"kernel": kname, "column": col, "stage": st.name, "n": st.n_out,
                   "bytes": stage_bytes(stage_inputs(st), env, st.n_out),
                   "ms": timer.ms(lambda: kfn(st, env)),
                   "plain_ms": timer.ms(lambda: pfn(st, env)), "library_ms": None}
            rec["bound_ms"] = rec["bytes"] / (hbm * 1e9) * 1e3
            if (isinstance(st, GroupParallel) and st.map_kind == IDENTITY
                    and not st.tail and st.values[0][0].kind == LOAD):
                vals = env[st.values[0][0].bufs[0]]
                counts = torch.diff(env[st.presum]).long()
                rec["library_ms"] = timer.ms(
                    lambda: torch.repeat_interleave(vals, counts,
                                                    output_size=st.n_out))
                same(torch.repeat_interleave(vals, counts, output_size=st.n_out)
                     .to(plain.dtype), plain, f"{col}:{st.name} repeat_interleave")
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
    for col in SLICE_COLUMNS:
        walk(pipe.executor.graph(col), device_buffers(pipe.encoded(col)), col)
    rng = np.random.default_rng(args.seed)
    for bw in FP_BWS:
        for n in FP_NS:
            lo, hi = (-2**31, 2**31) if bw == 32 else (0, 1 << bw)
            arr = rng.integers(lo, hi, n).astype(np.int32)
            enc = encode(Plan("bitpack", params={"bit_width": bw}), arr)
            out = walk(build_graph(enc), device_buffers(enc), f"sweep bw={bw} n={n}",
                       timed=False)
            same(out.cpu(), torch.from_numpy(arr), f"sweep bw={bw} n={n} vs source")
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
    print(f"compare: {compared} kernel launches bitwise equal to plain "
          f"({time.perf_counter() - t0:.1f} s)")
    for r in stages:
        lib = "" if r["library_ms"] is None else f" library_ms {r['library_ms']:.4f}"
        print(f"stage {r['kernel']:14s} {r['column']:16s} {r['stage']:28s} n {r['n']:9d} "
              f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.4f}{lib}")

    # ---------------------------------------------------------------- phase 4
    FP.launches = GP.launches = 0
    makespans, host_ms = [], []
    for label in ("cold",) + ("warm",) * WARM_RUNS:
        res = None      # drop the last run's columns: a warm run reuses their memory
        t0 = time.perf_counter()
        res = pipe.run()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        for col in SLICE_COLUMNS:
            got = res[col].array.cpu()
            same(got, torch.from_numpy(cols[col]), f"{label} run {col} vs source")
        makespans.append(pipe.makespan_s)
    launches = {"fully_parallel": FP.launches, "group_parallel": GP.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not run on the main path: {launches}")
    plain_exec = StreamingExecutor(backend="torch", device=pipe.device)
    for col in SLICE_COLUMNS:
        plain_exec.compile(col, pipe.encoded(col))
    for _ in range(2):
        pres = plain_exec.run()
    for col in SLICE_COLUMNS:
        same(pres[col].array.cpu(), torch.from_numpy(cols[col]), f"plain run {col}")
    pres = None
    for r in res.values():
        r.array = None  # keep the records, free the columns before the traced run
    # one more warm run under the profiler: where the device's time goes
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced = pipe.run()
    device_ms = {"h2d_copy": 0.0, "fully_parallel": 0.0, "group_parallel": 0.0,
                 "torch_ops": 0.0}
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = ("h2d_copy" if "Memcpy" in e.name else
                "fully_parallel" if "zf_fully_parallel" in e.name else
                "group_parallel" if "zf_group_parallel" in e.name else "torch_ops")
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
    for col in SLICE_COLUMNS:
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
            "bound_by": "bytes", "library_ms": big["library_ms"],
            "matches_plain": True, "at": f"{big['column']}:{big['stage']}",
            "n": big["n"], "launches_per_run": launches[kname] // len(makespans),
            "main_path_ms": sum(r["ms"] for r in mine),
            "main_path_plain_ms": sum(r["plain_ms"] for r in mine),
            "main_path_bound_ms": sum(r["bound_ms"] for r in mine)})
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
