#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--scale S] [--seed N] [--out FILE.json]

Phases, in order; none catches its own failure, so any error or mismatch exits
non-zero before the final line:

  1. fail unless CUDA is available;
  2. build the four hand-written kernels from ``src/repro_torch/kernels/csrc``
     (``nvcc``, ``sm_90a``, one process per source, all at once) and load
     every kernel of them on the card (``preload`` line: the time CUDA's lazy
     module loading would otherwise add to first launches), then generate
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
     tail; tables outside the packed layout).  Then the chunk and span entries
     at 1 MiB chunks: one element chunk of each column that splits (kernel 1),
     every span of L_ORDERKEY under the reference's ``rle`` candidate plan and
     of O_ORDERKEY under ``deltastride`` (kernel 2), and L_RETURNFLAG's rANS
     spans (kernel 3; two of them against the plain version, which takes
     about a second a call, all of them through the column's equality with
     its whole decode), each timed beside the whole-column launch.  Then the
     batched entries, at K = 2, 8 and one above each kernel's per-launch limit
     (the split): kernel 1 on L_DISCOUNT + L_TAX, kernel 2 on two RLE columns
     of one structure whose runs differ, kernel 3 on L_RETURNFLAG and a copy
     with its rANS chunks in another order; each held bitwise against its
     plain batched version and against K single launches, and timed at K = 2
     beside the two single launches;
  4. the FIFO whole-column path as it ran before the planner (``policy="fifo"``,
     ``chunk_bytes=None``, ``batch_columns=False``, passed explicitly, planned
     once outside the timed runs at the fixed window of 2 decode units):
     ``ColumnPipeline(..., device="cuda").run(plan=...)`` once cold and
     ``WARM_RUNS`` times warm, with the launch counts zeroed just before; every
     column must equal its source bitwise.  Then the same blobs through the
     plain backend, and one more warm run of this path and of the 1 MiB
     chunked path under one ``torch.profiler`` session for the device's busy
     time by kind.  Then the plain-copy yardstick (the plain
     columns copied from pinned memory on the executor's copy stream), and the
     chunked paths: ``ColumnPipeline(..., chunk_bytes=1 << 20,
     chunk_decode=True)`` and the same at 4 MiB (FIFO, no batching, planned
     once at window 2, as for the whole path), each cold and ``WARM_RUNS`` times warm with the counts zeroed just before,
     every column equal to its source; and the same for the two kernel-2 span
     columns.  Then the host time of one whole-column and one chunked 1 MiB
     run (``run(window=2)``, so each plans inside the run, as a caller's does)
     split by ``torch.profiler``'s Python tracer into planning, argument
     packing, the launch calls, views, events, cache lookups, copies and the
     rest (``host_split`` lines);
  5. the planner's paths: ``ColumnPipeline(plans, device="cuda")`` under the
     reference's defaults (chunk-johnson, 1 MiB transfer chunks, batching),
     then ``policy="adaptive", chunk_bytes="auto", chunk_decode=True`` planned
     from the seeded chip model and again after those runs calibrated the
     cost model; each plan run cold and ``WARM_RUNS`` times warm with the
     counts zeroed just before, every column equal to its source; at SF 1 and
     seed 0 the reference-default plan must batch L_DISCOUNT + L_TAX, with one
     batched kernel-1 launch a run and no other batched launch.  ``planner``
     lines give the modeled and measured makespans, the baselines, the
     decisions by mode, decode units and launches per run, the batched groups
     and their batched-entry launches, and the calibrated
     ``launch_overhead_s`` beside the host time per added decode unit;
  6. the decode-fused queries (kernel 4, ``csrc/query_reduce.cu``): TPC-H Q1
     and Q6 lowered onto their columns (``ColumnPipeline.lower_query``), each
     run through ``run_query`` whole (one chunk, ``executor.run_query(...,
     chunk_bytes=None)``), chunked at 1 MiB (``ColumnPipeline(chunk_bytes=1 <<
     20)``) and in the loader's searched configuration
     (``ColumnPipeline(chunk_bytes=None)``), each cold + ``WARM_RUNS`` warm,
     with the counts zeroed just before the query runs and read just after
     (Q1 also runs kernel 3 for its resident L_RETURNFLAG).  The count lane
     must equal a numpy count over the source columns exactly, and the result
     the materialize-then-query torch engine on the card (the port's ``run`` of
     the query's columns, then ``data/queries.py``) within ``rtol`` 1e-4, the
     reference example's tolerance (the sums are taken in another order).
     Then every kernel-4 launch of those runs is repeated on the same chunk
     against its plain version: the count lane bitwise, the float lanes within
     1e-5 relative (each row's values are the same bits; only the order of the
     sums differs).  ``query`` lines give the fused makespan by CUDA events and
     the host time, ``materialize_ms``, the kernel's whole-launch time, its
     plain version's and ``bound_ms`` (``fusion.hbm_traffic_bytes`` at the HBM
     rate), chunks, launches and selectivity;
  7. report: per-column lines, a totals line, the ``{"kernels": [...]}`` line
     (kernel 4's object beside the three decode kernels'), the card's name and
     power limit from ``nvidia-smi``, and last ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import re
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
# kernel 4 replaces no TPU kernel: the reference's Reduce runs under XLA jit
QUERY_KERNEL = ("query_reduce", "src/repro_torch/kernels/csrc/query_reduce.cu",
                "src/repro/core/compiler.py:204 (XLA, no pallas_call)")
QUERY_RTOL = 1e-4          # fused vs materialize-then-query: sums in another order
QUERY_KERNEL_RTOL = 1e-5   # kernel vs plain: the same row values, another sum order
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
CHUNK_SIZES = (1 << 20, 4 << 20)  # chunk_bytes of the chunked paths
# kernel 2's span columns: the reference's candidate plans of the key columns
# (no Table-2 column reaches a Group-Parallel span at SF 1)
SPAN_PLANS = {"L_ORDERKEY": "rle", "O_ORDERKEY": "deltastride"}
# decode units per run the reference's ``StreamingExecutor.chunk_schedule``
# gives the 24 Table-2 columns at SF 1, seed 0
REF_UNITS_SF1 = {1 << 20: 109, 4 << 20: 41}
NP_PLAIN_SPANS = 2                # rANS spans held against the plain version
# the FIFO whole-column configuration the phases before the planner's run in
FIFO_WHOLE = {"policy": "fifo", "chunk_bytes": None, "batch_columns": False}


def host_part(name: str) -> str | None:
    """The part of the host's work a ``torch.profiler`` event of a run belongs
    to: Python calls are named ``path(line): function``, torch ops ``aten::...``;
    None for the rest (the executor's own loop, dict and list work)."""
    m = re.match(r"(.*)\((\d+)\): (\S+)$", name)
    path, fn = (m.group(1), m.group(3)) if m else ("", "")
    if path.endswith(("core/planner.py", "core/scheduler.py")) or \
            (path.endswith("core/executor.py") and fn in ("plan", "issue_order")):
        return "planning"
    if path.endswith("core/costmodel.py"):
        return "cost_model"
    if path.endswith("kernels/cuda.py"):
        return "launch_call" if fn in ("launch", "launch_batched") else "arg_packing"
    if fn in ("_launch_args", "kernel_out", "finish", "into", "stage_device",
              "batch_device", "chain_dtype", "gp_dtype", "np_dtype", "native_config"):
        return "arg_packing"
    if path.endswith("core/executor.py") and fn == "views":
        return "views"
    if "torch/cuda/" in path:
        return "events_streams"
    if (path.endswith("core/compiler.py") and fn in ("_get", "_lookup", "get", "get_chunk",
                                                     "get_group_chunk", "get_group_prologue")) \
            or (path.endswith("core/executor.py") and fn in ("_staging", "_column", "_units",
                                                             "chunk_schedule")):
        return "cache_lookup"
    if name.startswith("aten::copy_"):
        return "copies"
    if name.startswith("aten::empty"):
        return "allocation"
    if name.startswith("aten::"):
        return "torch_ops"          # the Aux ops' launches and other tensor work
    return None


HOST_PARTS = ("planning", "cost_model", "arg_packing", "launch_call", "views",
              "events_streams", "cache_lookup", "copies", "allocation", "torch_ops")


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


def mib(chunk_bytes: int) -> str:
    """A chunk size as a label: 1MiB, 4MiB, 64KiB."""
    return f"{chunk_bytes >> 20}MiB" if chunk_bytes >= 1 << 20 else f"{chunk_bytes >> 10}KiB"


def unit_env(enc, sched, k: int, whole_env: dict, device="cuda") -> dict:
    """What chunk k of ``sched`` reads, on the card: the whole buffers and its
    own slices of the sliced leaves (row-capped stripes included)."""
    from repro_torch.core.compiler import device_layout
    from repro_torch.core.plan import host_operands

    ops = host_operands(enc)
    env = {n: (torch.from_numpy(device_layout(sched.host_push[n])).to(device)
               if n in sched.host_push else whole_env[n]) for n in sched.whole}
    for leaf in sched.slices:
        env[leaf] = torch.from_numpy(device_layout(
            sched.piece(np.asarray(ops[leaf]), leaf, k))).to(device)
    return env


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


def query_truth(q: int, cols: dict) -> np.ndarray:
    """The count lane from the source columns, in numpy: Q6's selected rows,
    Q1's selected rows per group key."""
    if q == 6:
        d = cols["L_DISCOUNT"]
        m = ((cols["L_SHIPDATE"] >= 8766) & (cols["L_SHIPDATE"] < 9131)
             & (d >= np.float32(0.05)) & (d <= np.float32(0.07)) & (cols["L_QUANTITY"] < 24))
        return np.array([m.sum()], np.float64)
    sel = cols["L_SHIPDATE"] <= 10000
    key = np.mod(cols["L_RETURNFLAG"].astype(np.int64) - 65, 4) * 2 + cols["L_LINESTATUS"]
    return np.bincount(key[sel], minlength=8)[:8].astype(np.float64)


def run_queries(args, cols: dict, encoded: dict, timer, hbm: float, libs) -> dict:
    """Phase 6: TPC-H Q1 and Q6 decode-fused on the card (see the module
    docstring); returns the ``query`` records and kernel 4's ``kernels`` object."""
    from repro_torch.core.fusion import hbm_traffic_bytes
    from repro_torch.data.columns import TABLE2_PLANS
    from repro_torch.data.loader import ColumnPipeline
    from repro_torch.data.queries import Q1_PLAN, Q6_PLAN, q1_engine, q6_engine
    from repro_torch.data.tpch import QUERY_COLUMNS
    from repro_torch.kernels import ref
    from repro_torch.kernels.query_reduce import KERNEL as QR, query_reduce

    plans = {1: Q1_PLAN, 6: Q6_PLAN}
    engines = {1: q1_engine, 6: q6_engine}
    runs, checks, per_query = [], [], {}
    err = 0.0
    for lib in libs + (QR,):
        lib.launches = 0

    def drive(q, label, call):
        """Cold + WARM_RUNS warm runs of one configuration; each result checked."""
        spans, hosts, out = [], [], None
        for _ in ("cold",) + ("warm",) * WARM_RUNS:
            t0 = time.perf_counter()
            out = call()
            hosts.append((time.perf_counter() - t0) * 1e3)
            spans.append(out.makespan_s * 1e3)
            counts = np.asarray(out.acc.cpu())[-out.acc.numel() // (len(plans[q].aggregates) + 1):]
            truth = query_truth(q, cols)
            if not np.array_equal(counts.astype(np.float64), truth):
                raise AssertionError(f"q{q} {label}: count lane {counts.tolist()} "
                                     f"!= numpy {truth.tolist()}")
            checks.append((q, label, out))
        return {"query": f"q{q}", "config": label, "fused_ms": float(np.median(spans[1:])),
                "fused_ms_cold": spans[0], "fused_ms_warm_min": min(spans[1:]),
                "fused_ms_warm_max": max(spans[1:]), "host_ms": float(np.median(hosts[1:])),
                "chunks": out.n_chunks, "launches": out.decode_launches,
                "selectivity": out.selectivity, "transfer_ms": out.transfer_s * 1e3,
                "decode_ms": out.decode_s * 1e3, "traffic_bytes": out.traffic_bytes,
                "prefuse_traffic_bytes": out.prefuse_traffic_bytes,
                "compressed_bytes": out.compressed_bytes, "plain_bytes": out.plain_bytes}

    pipes = {}
    for q, qp in plans.items():
        names = QUERY_COLUMNS[q]
        chunked = ColumnPipeline({c: TABLE2_PLANS[c] for c in names}, device="cuda",
                                 chunk_bytes=1 << 20)
        searched = ColumnPipeline({c: TABLE2_PLANS[c] for c in names}, device="cuda",
                                  chunk_bytes=None)
        for p_ in (chunked, searched):
            p_.load({c: encoded[c] for c in names})
        fq, encs = chunked.lower_query(qp)
        pipes[q] = (chunked, searched, fq, encs)
        runs.append(drive(q, "whole", lambda: chunked.executor.run_query(fq, encs,
                                                                          chunk_bytes=None)))
        runs.append(drive(q, "chunked 1MiB", lambda: chunked.run_query(qp)))
        runs.append(drive(q, "searched", lambda: searched.run_query(qp)))
    launches = {lib.name: lib.launches for lib in libs + (QR,)}
    if QR.launches <= 0 or launches["non_parallel"] <= 0:
        raise AssertionError(f"the query path did not run kernels 3 and 4: {launches}")
    want = sum(r["launches"] for r in runs) * (WARM_RUNS + 1)
    if QR.launches != want:
        raise AssertionError(f"kernel 4 made {QR.launches} launches, the runs {want}")

    # every kernel-4 launch of those runs, repeated on its chunk against the plain version
    compared, rel = 0, 0.0
    for q, (chunked, searched, fq, encs) in pipes.items():
        red = fq.graph.stages[-1]
        res = {}
        for c in fq.resident:
            res[fq.resident_input(c)] = torch.from_numpy(cols[c]).cuda()
        for label, p_, cb in (("whole", chunked, None), ("chunked 1MiB", chunked, 1 << 20),
                              ("searched", searched, searched._query_cfg[plans[q].digest()][1])):
            sched, staged = p_.executor._query_staging(fq, cb)
            flat = staged.host.cuda()
            for k in range(sched.n_chunks):
                env = {**staged.views(flat, k), **res}
                kw = dict(n=sched.out_sizes[k], out_start=sched.out_starts[k])
                got = query_reduce(red, env, **kw)
                plain = ref.query_reduce_torch(red, env, **kw)
                S = fq.n_segments
                if not torch.equal(got[-S:], plain[-S:]):
                    raise AssertionError(f"q{q} {label} chunk {k}: count lane "
                                         f"{got[-S:].tolist()} != plain {plain[-S:].tolist()}")
                if not torch.allclose(got, plain, rtol=QUERY_KERNEL_RTOL, atol=0):
                    raise AssertionError(f"q{q} {label} chunk {k}: kernel {got.tolist()} "
                                         f"vs plain {plain.tolist()}")
                diff = (got.double() - plain.double()).abs()
                err = max(err, diff.max().item())
                rel = max(rel, (diff / plain.double().abs().clamp(min=1e-30)).max().item())
                compared += 1

    # materialize-then-query: the port's run of the query's columns, then the engine
    for q, qp in plans.items():
        chunked, searched, fq, encs = pipes[q]
        names = QUERY_COLUMNS[q]
        mat = ColumnPipeline({c: TABLE2_PLANS[c] for c in names}, device="cuda",
                             chunk_bytes=None)
        mat.load({c: encoded[c] for c in names})
        host_ms, dev_ms, result = [], [], None
        for _ in ("cold",) + ("warm",) * WARM_RUNS:
            t0 = time.perf_counter()
            out = mat.run()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            result = engines[q]({c: out[c].array for c in names})
            b.record()
            b.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(mat.makespan_s * 1e3 + a.elapsed_time(b))
        result = result.cpu().numpy()
        for r in runs:
            if r["query"] != f"q{q}":
                continue
            last = next(o for qq, lbl, o in reversed(checks) if qq == q and lbl == r["config"])
            got = np.asarray(last.result)
            if not np.allclose(got, result, rtol=QUERY_RTOL, atol=0):
                raise AssertionError(f"q{q} {r['config']}: fused {got.tolist()} vs "
                                     f"materialize-then-query {result.tolist()}")
            r["materialize_ms"] = float(np.median(host_ms[1:]))
            r["materialize_device_ms"] = float(np.median(dev_ms[1:]))
        # kernel 4's whole launch beside its plain version and its bound
        red = fq.graph.stages[-1]
        sched, staged = chunked.executor._query_staging(fq, None)
        env = {**staged.views(staged.host.cuda(), 0)}
        for c in fq.resident:
            env[fq.resident_input(c)] = torch.from_numpy(cols[c]).cuda()
        nbytes = hbm_traffic_bytes(fq.graph.stages, {**fq.operands, **{
            k: v for k, v in env.items() if k.endswith(".resident")}})
        per_query[f"q{q}"] = {
            "ms": timer.ms(lambda: query_reduce(red, env)),
            "plain_ms": timer.ms(lambda: ref.query_reduce_torch(red, env), 3),
            "bound_ms": nbytes / (hbm * 1e9) * 1e3, "bytes": nbytes,
            "launches_per_query": {r["config"]: r["launches"] for r in runs
                                   if r["query"] == f"q{q}"}}
    for r in runs:
        k = per_query[r["query"]]
        r.update(kernel_ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"])
        print(f"query {r['query']} {r['config']} " + " ".join(
            f"{key} {v:.4f}" if isinstance(v, float) else f"{key} {v}"
            for key, v in r.items() if key not in ("query", "config")))
    print(f"query compare: {compared} kernel-4 launches held against the plain version, "
          f"count lanes bitwise, float lanes max abs err {err:.6g}, max rel err {rel:.6g}; "
          f"main-path launches {launches}")
    big = per_query["q1"]
    kernel = {"name": QUERY_KERNEL[0], "route": "cuda", "source": QUERY_KERNEL[1],
              "replaces": QUERY_KERNEL[2], "launches": launches["query_reduce"],
              "max_abs_err": err, "max_rel_err": rel,
              "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
              "bound_by": "bytes", "library_ms": None, "matches_plain": True,
              "at": "q1 whole (one launch over every row)", "compared": compared,
              "per_query": per_query,
              "materialize_ms": {r["query"]: r["materialize_ms"] for r in runs
                                 if r["config"] == "whole"}}
    return {"runs": runs, "kernel": kernel}


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
    from repro_torch.core.compiler import build_graph, device_buffers, span_stage
    from repro_torch.core.executor import StreamingExecutor
    from repro_torch.core.geometry import Geometry, chip_from_device, native_config
    from repro_torch.core.ir import group_chunk_layout
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
    from repro_torch.kernels.fully_parallel import (KERNEL as FP, fully_parallel,
                                                    fully_parallel_batched)
    from repro_torch.kernels.group_parallel import (KERNEL as GP, group_parallel,
                                                    group_parallel_batched, tile_windows)
    from repro_torch.kernels.non_parallel import (KERNEL as NP, decode_table, non_parallel,
                                                  non_parallel_batched)
    from repro_torch.kernels.ops import run_stage
    from repro_torch.kernels.query_reduce import KERNEL as QR, query_reduce

    columns = tuple(TABLE2_PLANS)
    libs = (FP, GP, NP)         # the decode kernels; kernel 4 (QR) runs in phase 6

    name = torch.cuda.get_device_name(0)
    spec = chip_from_device(0)
    hbm = spec.hbm_gbps
    print(f"device: {name}  torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"sms {spec.sms}  l2_mb {spec.l2_bytes / 2**20:.0f}  hbm_bound_gbps {hbm} "
          f"({spec.source})")

    # ---------------------------------------------------------------- phase 2
    t0 = time.perf_counter()
    cuda.build(libs + (QR,))
    for lib in libs + (QR,):
        lib.load(torch.device("cuda", 0))    # every kernel loaded on the card now
    built = " ".join(f"{lib.name} {lib.build_s:.1f} s" for lib in libs + (QR,)
                     if lib.build_s is not None)
    print(f"build: {time.perf_counter() - t0:.2f} s ({built or 'cached'}) -> "
          f"{FP.path().parent}")
    print("preload: " + " ".join(f"{lib.name}_ms {lib.preload_s[0] * 1e3:.4f}"
                                 for lib in libs + (QR,)))
    for lib in libs + (QR,):
        for line in lib.path().with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib.name}: {line.strip()}")

    t0 = time.perf_counter()
    cols = generate(args.scale, seed=args.seed)
    cols = {k: cols[k] for k in columns}
    t_gen = time.perf_counter() - t0
    pipe = ColumnPipeline(dict(TABLE2_PLANS), device="cuda", **FIFO_WHOLE)
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

    # the chunk and span entries, at the shapes the chunked path gives them
    fifo = {"policy": "fifo", "batch_columns": False}
    chunk_pipes = {cb: ColumnPipeline(dict(TABLE2_PLANS), device="cuda", chunk_bytes=cb,
                                      chunk_decode=True, **fifo) for cb in CHUNK_SIZES}
    span_pipes = {cb: ColumnPipeline({c: make_plan(p) for c, p in SPAN_PLANS.items()},
                                     device="cuda", chunk_bytes=cb, chunk_decode=True,
                                     **fifo)
                  for cb in CHUNK_SIZES}
    for cb in CHUNK_SIZES:
        chunk_pipes[cb].load({c: pipe.encoded(c) for c in columns})
        if cb == CHUNK_SIZES[0]:
            span_pipes[cb].compress({c: cols[c] for c in SPAN_PLANS})
        else:
            span_pipes[cb].load({c: span_pipes[CHUNK_SIZES[0]].encoded(c)
                                 for c in SPAN_PLANS})
    entries = []          # one record per timed chunk or span entry

    def entry(kname, col, what, n, call, whole_call, whole_n, plain_call=None,
              plain_reps=None):
        rec = {"kernel": kname, "column": col, "entry": what, "n": n,
               "ms": timer.ms(call), "whole_n": whole_n, "whole_ms": timer.ms(whole_call),
               "plain_ms": None if plain_call is None else timer.ms(plain_call, plain_reps)}
        entries.append(rec)

    def check_entries(p_, col):
        sched = p_.executor.chunk_schedule(col)
        if sched is None:
            return
        enc, graph = p_.encoded(col), p_.executor.graph(col)
        whole_env = device_buffers(enc)
        want = torch.from_numpy(cols[col])
        out = torch.empty(graph.n_out, dtype=ref.torch_dtype(graph.out_dtype), device="cuda")
        K = sched.n_chunks
        if sched.kind == "element":
            (st,) = graph.stages           # one fused chain on every Table-2 column
            k = K // 2
            env = unit_env(enc, sched, k, whole_env)
            s, n = sched.out_starts[k], sched.out_sizes[k]
            fully_parallel(st, env, n=n, out=out[s:s + n])
            err["fully_parallel"] = max(err["fully_parallel"], same(
                out[s:s + n], ref.fully_parallel_torch(st, env, n), f"{col} chunk {k}"))
            compared["fully_parallel"] += 1
            same(out[s:s + n].cpu(), want[s:s + n], f"{col} chunk {k} vs source")
            entry("fully_parallel", col, f"chunk {k}/{K}", n,
                  lambda: fully_parallel(st, env, n=n, out=out[s:s + n]),
                  lambda: fully_parallel(st, whole_env), st.n_out,
                  lambda: ref.fully_parallel_torch(st, env, n))
            return
        layout = group_chunk_layout(graph)
        if graph.stages[layout.stage_index + 1:]:
            raise AssertionError(f"{col}: a stage after the group stage")
        pro = p_.executor.cache.get_group_prologue(graph, "kernel")
        resident = pro(unit_env(enc, sched, 0, whole_env)) if pro is not None else {}
        st, gst = span_stage(graph), graph.stages[layout.stage_index]
        envs = [{**unit_env(enc, sched, k, whole_env), **resident} for k in range(K)]
        whole = {**whole_env, **resident}
        for k, env in enumerate(envs):
            s, n, g0, gz = (sched.out_starts[k], sched.out_sizes[k], sched.g_starts[k],
                            sched.g_sizes[k])
            if layout.kind == "gp":
                group_parallel(st, env, out=out[s:s + n], out_start=s, g_start=g0,
                               n_valid=n, g_size=gz)
                err["group_parallel"] = max(err["group_parallel"], same(
                    out[s:s + n], ref.group_parallel_torch(st, env, s, g0, n),
                    f"{col} span {k}"))
                compared["group_parallel"] += 1
            else:
                non_parallel(st, env, n_chunks=gz, n=n, out=out[s:s + n])
                if k in (0, K - 1)[:NP_PLAIN_SPANS]:
                    err["non_parallel"] = max(err["non_parallel"], same(
                        out[s:s + n], ref.non_parallel_torch(st, env, gz, n),
                        f"{col} span {k}"))
                    compared["non_parallel"] += 1
        kname = "group_parallel" if layout.kind == "gp" else "non_parallel"
        same(out, run_stage(gst, whole, "kernel"), f"{col}: {K} spans vs whole decode")
        same(out.cpu(), want, f"{col}: {K} spans vs source")
        s, n, g0, gz = (sched.out_starts[0], sched.out_sizes[0], sched.g_starts[0],
                        sched.g_sizes[0])
        if layout.kind == "gp":
            entry(kname, col, f"span 0/{K}", n,
                  lambda: group_parallel(st, envs[0], out=out[s:s + n], out_start=s,
                                         g_start=g0, n_valid=n, g_size=gz),
                  lambda: group_parallel(gst, whole), gst.n_out,
                  lambda: ref.group_parallel_torch(st, envs[0], s, g0, n))
        else:
            entry(kname, col, f"span 0/{K}", n,
                  lambda: non_parallel(st, envs[0], n_chunks=gz, n=n, out=out[s:s + n]),
                  lambda: non_parallel(gst, whole), gst.n_out,
                  lambda: ref.non_parallel_torch(st, envs[0], gz, n), 1)

    for col in columns:
        check_entries(chunk_pipes[CHUNK_SIZES[0]], col)
    for col in SPAN_PLANS:
        check_entries(span_pipes[CHUNK_SIZES[0]], col)
    for kname in KERNELS:
        if not any(r["kernel"] == kname for r in entries):
            raise AssertionError(f"no chunk or span entry of {kname} was checked")

    # the batched entries: K members of one structure, one launch per the
    # kernel's limit of members, against the plain batched version and K
    # single launches
    batched = []          # one record per kernel and K
    batch_kinds = {"fully_parallel": (FP, fully_parallel, fully_parallel_batched,
                                      ref.fully_parallel_batched_torch),
                   "group_parallel": (GP, group_parallel, group_parallel_batched,
                                      ref.group_parallel_batched_torch),
                   "non_parallel": (NP, non_parallel, non_parallel_batched,
                                    ref.non_parallel_batched_torch)}

    def member_env(enc, upto):
        """The card's operands of a blob and the results of its stages before
        stage ``upto`` (plain versions), what that stage reads."""
        graph = build_graph(enc)
        env = device_buffers(enc)
        for st in graph.stages[:upto]:
            env[st.out] = run_stage(st, env, "torch")
        return graph.stages[upto], env

    def check_batched(kname, encs, what):
        lib, single, kbatch, pbatch = batch_kinds[kname]
        sigs = {build_graph(e).signature for e in encs}
        if len(sigs) != 1:
            raise AssertionError(f"batched {kname}: {what} are not one structure")
        graph = build_graph(encs[0])
        upto = next(i for i, st in enumerate(graph.stages)
                    if type(st).__name__ == {"fully_parallel": "FullyParallel",
                                             "group_parallel": "GroupParallel",
                                             "non_parallel": "NonParallel"}[kname])
        pairs = [member_env(e, upto) for e in encs]
        st = pairs[0][0]
        for k in sorted({2, 8, lib.batch_max + 1}):
            envs = [pairs[i % len(pairs)][1] for i in range(k)]
            before = lib.batched_launches
            got = kbatch(st, envs)
            torch.cuda.synchronize()
            split = lib.batched_launches - before
            if split != -(-k // lib.batch_max):
                raise AssertionError(f"batched {kname} K={k}: {split} launches, the "
                                     f"limit is {lib.batch_max} members")
            plains = pbatch(st, envs)
            for i, (g, env) in enumerate(zip(got, envs)):
                err[kname] = max(err[kname], same(g, plains[i], f"batched {kname} K={k} #{i}"))
                same(g, single(st, env), f"batched {kname} K={k} #{i} vs a single launch")
            compared[kname] += k
            rec = {"kernel": kname, "what": what, "stage": st.name, "k": k,
                   "launches": split, "n": st.n_out}
            if k == 2:
                outs = [torch.empty_like(g) for g in got]
                rec["ms"] = timer.ms(lambda: kbatch(st, envs, outs=outs))
                rec["singles_ms"] = timer.ms(lambda: [single(st, e, out=o)
                                                      for e, o in zip(envs, outs)])
                rec["plain_ms"] = timer.ms(lambda: pbatch(st, envs),
                                           3 if kname == "non_parallel" else None)
                rec["bytes"] = sum(stage_bytes(stage_inputs(st), e, g)
                                   for e, g in zip(envs, got))
                rec["bound_ms"] = rec["bytes"] / (hbm * 1e9) * 1e3
            batched.append(rec)

    check_batched("fully_parallel", [pipe.encoded(c) for c in ("L_DISCOUNT", "L_TAX")],
                  "L_DISCOUNT + L_TAX")
    keys = cols["L_ORDERKEY"]
    cut = np.flatnonzero(np.diff(keys)) + 1
    runs = np.diff(np.concatenate([[0], cut, [keys.size]]))
    vals = keys[np.concatenate([[0], cut])]
    swapped = np.repeat(vals, runs[::-1]).astype(keys.dtype)   # the same runs, reversed
    check_batched("group_parallel", [encode(make_plan("rle"), a) for a in (keys, swapped)],
                  "L_ORDERKEY rle and its runs reversed")
    flags = cols["L_RETURNFLAG"]
    chunk = 4096
    body = flags[:flags.size // chunk * chunk].reshape(-1, chunk)
    shuffled = np.concatenate([body[np.random.default_rng(args.seed).permutation(len(body))]
                               .reshape(-1), flags[body.size:]])
    check_batched("non_parallel", [encode(TABLE2_PLANS["L_RETURNFLAG"], a)
                                   for a in (flags, shuffled)],
                  "L_RETURNFLAG and its rANS chunks reordered")
    print(f"compare: {compared} kernel launches bitwise equal to plain, of them "
          f"kernel-1 cases {fp_cases} ({time.perf_counter() - t0:.1f} s)")
    for r in entries:
        plain = "" if r["plain_ms"] is None else f" plain_ms {r['plain_ms']:.4f}"
        print(f"entry {r['kernel']:14s} {r['column']:16s} {r['entry']:12s} n {r['n']:9d} "
              f"ms {r['ms']:.4f} whole_n {r['whole_n']:9d} whole_ms {r['whole_ms']:.4f}"
              f"{plain}")
    for r in batched:
        timed = "".join(f" {k} {r[k]:.4f}" for k in ("ms", "singles_ms", "plain_ms", "bound_ms")
                        if k in r)
        print(f"batched {r['kernel']:14s} {r['what']:40s} {r['stage']:20s} K {r['k']:2d} "
              f"launches {r['launches']} n {r['n']:9d}{timed}")
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
    whole_plan = pipe.plan(window=2)    # planned once, at the pre-planner window of 2
    for label in ("cold",) + ("warm",) * WARM_RUNS:
        res = None      # drop the last run's columns: a warm run reuses their memory
        t0 = time.perf_counter()
        res = pipe.run(plan=whole_plan)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        for col in columns:
            got = res[col].array.cpu()
            same(got, torch.from_numpy(cols[col]), f"{label} run {col} vs source")
        makespans.append(pipe.makespan_s)
    launches = {k: lib.launches for k, lib in zip(KERNELS, libs)}
    launches_warm = {k: v // (WARM_RUNS + 1) for k, v in launches.items()}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not run on the main path: {launches}")
    plain_exec = StreamingExecutor(backend="torch", device=pipe.device, **FIFO_WHOLE)
    for col in columns:
        plain_exec.compile(col, pipe.encoded(col))
    for _ in range(2):
        pres = plain_exec.run()
    for col in columns:
        same(pres[col].array.cpu(), torch.from_numpy(cols[col]), f"plain run {col}")
    pres = None
    for r in res.values():
        r.array = None  # keep the records, free the columns before the traced run
    # one more warm run under the profiler, and one of the chunked path at
    # 1 MiB (warmed up first), in one session: where the device's time goes
    chunk_trace = chunk_pipes[CHUNK_SIZES[0]]
    chunk_trace.run(window=2)
    marks = {"whole": pipe, f"chunked {mib(CHUNK_SIZES[0])}": chunk_trace}
    traced_ms = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for label, p_ in marks.items():
            with torch.profiler.record_function(f"run {label}"):
                traced = p_.run(window=2)
            traced_ms[label] = p_.makespan_s * 1e3
            traced = None
    events = prof.events()
    for label in marks:
        (m,) = [e for e in events if e.name == f"run {label}"
                and e.device_type == torch.autograd.DeviceType.CPU]
        device_ms = {"h2d_copy": 0.0, **{k: 0.0 for k in KERNELS}, "torch_ops": 0.0}
        spans = []
        for e in events:
            # the device timeline also carries each record_function range (a
            # user annotation per stream, named like it), which is not work
            if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith("run ") \
                    or not m.time_range.start <= e.time_range.start <= m.time_range.end:
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
        if sum(device_ms.values()) <= 0:
            raise AssertionError(f"the profiled {label} run shows no device work")
        print(f"device {label} " + " ".join(f"{k}_ms {v:.4f}" for k, v in device_ms.items())
              + f" busy_ms {busy_us / 1e3:.4f} traced_makespan_ms {traced_ms[label]:.4f} "
              f"busy_share {busy_us / 1e3 / traced_ms[label]:.4f}")

    # where the host's time per run goes: one whole-column and one chunked
    # 1 MiB run under torch.profiler's Python tracer (CPU side only), each
    # event of the executor's ``run`` put in the first part that claims it
    host_split = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                with_stack=True) as prof:
        for label, p_ in marks.items():
            t0 = time.perf_counter()
            traced = p_.run(window=2)       # planned inside the run, as a caller's is
            host_split[label] = {"traced_host_ms": (time.perf_counter() - t0) * 1e3,
                                 "decode_units": sum(r.decode_launches
                                                     for r in traced.values())}
            traced = None
    runs_ev = []

    def find_runs(e):
        if re.search(r"core/executor\.py\(\d+\): run$", e.name):
            runs_ev.append(e)
            return
        for ch in e.children:
            find_runs(ch)

    for root in prof.profiler.kineto_results.experimental_event_tree():
        find_runs(root)
    runs_ev.sort(key=lambda e: e.start_time_ns)
    if len(runs_ev) != len(marks):
        raise AssertionError(f"the Python tracer saw {len(runs_ev)} runs, not {len(marks)}")
    for (label, rec), ev in zip(host_split.items(), runs_ev):
        parts = dict.fromkeys(HOST_PARTS, 0.0)

        def claim(e, parts=parts):
            part = host_part(e.name)
            if part is not None:
                parts[part] += e.duration_time_ns / 1e6
                return
            for ch in e.children:
                claim(ch)

        for ch in ev.children:
            claim(ch)
        rec["run_ms"] = ev.duration_time_ns / 1e6
        rec.update(parts)
        rec["other"] = rec["run_ms"] - sum(parts.values())
        print(f"host_split {label} " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in rec.items()))
    (w_label, w), (c_label, c) = list(host_split.items())
    added = c["decode_units"] - w["decode_units"]
    per_unit = {k: (c[k] - w[k]) / added for k in ("run_ms",) + HOST_PARTS + ("other",)}
    host_split["per_added_unit_ms"] = per_unit
    print(f"host_split per_added_unit ({c_label} - {w_label}, {added} units) " + " ".join(
        f"{k} {v:.4f}" for k, v in per_unit.items()))

    # the plain-copy yardstick: the plain columns from pinned memory to the card
    # on the executor's copy stream, what moving them uncompressed would take
    stream = pipe.executor.copy_stream
    host_plain = [torch.from_numpy(cols[c].reshape(-1).view(np.uint8)).pin_memory()
                  for c in columns]
    dev_plain = [torch.empty_like(h, device="cuda") for h in host_plain]
    copy_ms = []
    for _ in range(WARM_RUNS + 1):       # the first copy warms up
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            a.record(stream)
            for h, d in zip(host_plain, dev_plain):
                d.copy_(h, non_blocking=True)
            b.record(stream)
        b.synchronize()
        copy_ms.append(a.elapsed_time(b))
    for c, d in zip(columns, dev_plain):
        same(d.cpu(), torch.from_numpy(cols[c].reshape(-1).view(np.uint8)), f"plain copy {c}")
    plain_copy_ms = float(np.median(copy_ms[1:]))
    host_plain = dev_plain = None

    # the chunked paths: per-chunk decode at 1 MiB and 4 MiB, and kernel 2's
    # span columns, each driven with the counts zeroed just before
    chunked = {}

    def drive(p_, names, label):
        plan = p_.plan(window=2)        # planned once, at the pre-planner window
        for lib in libs:
            lib.launches = 0
        spans, hosts, out = [], [], None
        for run in ("cold",) + ("warm",) * WARM_RUNS:
            out = None
            t0 = time.perf_counter()
            out = p_.run(plan=plan)
            hosts.append((time.perf_counter() - t0) * 1e3)
            for col in names:
                same(bits(out[col].array.cpu()), bits(torch.from_numpy(cols[col])),
                     f"{label} {run} run {col} vs source")
            spans.append(p_.makespan_s * 1e3)
        counts = {k: lib.launches for k, lib in zip(KERNELS, libs)}
        per_run = {k: v // (WARM_RUNS + 1) for k, v in counts.items()}
        for col in names:
            r = out[col]
            sched = p_.executor.chunk_schedule(col)
            if sched is not None and r.decode_launches < sched.n_chunks:
                raise AssertionError(f"{label} {col}: {r.decode_launches} decode units "
                                     f"for {sched.n_chunks} chunks")
            print(f"chunked {label:22s} {col:16s} n_chunks {r.n_chunks:4d} decode_launches "
                  f"{r.decode_launches:4d} chunk_decoded {int(r.chunk_decoded)} transfer_ms "
                  f"{r.transfer_s * 1e3:.4f} decode_ms {r.decode_s * 1e3:.4f} "
                  f"kernel_launches {r.kernel_launches}")
        units = sum(out[c].decode_launches for c in names)
        rec = {"window": plan.window, "makespan_ms": float(np.median(spans[1:])),
               "makespan_ms_cold": spans[0], "makespan_ms_warm_min": min(spans[1:]),
               "makespan_ms_warm_max": max(spans[1:]),
               "host_run_ms": float(np.median(hosts[1:])), "decode_units_per_run": units,
               "kernel_launches_per_run": sum(per_run.values()),
               "launches": counts, "launches_per_run": per_run}
        print(f"chunked {label} totals " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in rec.items() if k != "launches") + f" launches {counts}")
        return rec

    for cb in CHUNK_SIZES:
        rec = drive(chunk_pipes[cb], columns, f"table2 {mib(cb)}")
        if min(rec["launches"].values()) <= 0:
            raise AssertionError(f"a kernel did not run on the chunked path: {rec}")
        if args.scale == 1.0 and args.seed == 0 \
                and rec["decode_units_per_run"] != REF_UNITS_SF1[cb]:
            raise AssertionError(f"{rec['decode_units_per_run']} decode units at "
                                 f"{mib(cb)}, the reference's schedule gives "
                                 f"{REF_UNITS_SF1[cb]}")
        chunked[f"table2 {mib(cb)}"] = rec
        span = drive(span_pipes[cb], tuple(SPAN_PLANS), f"span columns {mib(cb)}")
        if span["launches"]["group_parallel"] <= 0:
            raise AssertionError(f"kernel 2 did not run on the span path: {span}")
        chunked[f"span columns {mib(cb)}"] = span
        chunk_pipes[cb] = span_pipes[cb] = None

    # ---------------------------------------------------------------- phase 5
    # the planner's paths, each plan driven with the counts zeroed just before
    whole_host = float(np.median(host_ms[1:]))
    one_mib = chunked[f"table2 {mib(CHUNK_SIZES[0])}"]
    host_per_unit_ms = ((one_mib["host_run_ms"] - whole_host)
                        / max(1, one_mib["decode_units_per_run"] - len(columns)))
    planned = {}

    def drive_plan(p_, plan, label, groups_must=None):
        """Cold plus ``WARM_RUNS`` warm runs of ``plan``; ``groups_must`` (the
        batched groups the plan must form, each one batched kernel-1 launch a
        run) is checked when given."""
        for lib in libs:
            lib.launches = lib.batched_launches = 0
        spans, hosts, out = [], [], None
        for run in ("cold",) + ("warm",) * WARM_RUNS:
            out = None
            t0 = time.perf_counter()
            out = p_.run(plan=plan)
            hosts.append((time.perf_counter() - t0) * 1e3)
            for col in columns:
                same(bits(out[col].array.cpu()), bits(torch.from_numpy(cols[col])),
                     f"planner {label} {run} run {col} vs source")
            spans.append(p_.makespan_s * 1e3)
        counts = {k: lib.launches for k, lib in zip(KERNELS, libs)}
        in_batch = {k: lib.batched_launches for k, lib in zip(KERNELS, libs)}
        per_run = {k: v // (WARM_RUNS + 1) for k, v in counts.items()}
        batch_per_run = {k: v // (WARM_RUNS + 1) for k, v in in_batch.items()}
        if min(counts.values()) <= 0:
            raise AssertionError(f"planner {label}: a kernel did not run: {counts}")
        groups = sorted({tuple(sorted((c,) + out[c].batched_with))
                         for c in columns if out[c].batched_with})
        if sum(in_batch.values()) < len(groups) * (WARM_RUNS + 1):
            raise AssertionError(f"planner {label}: batched groups {groups} made "
                                 f"{in_batch} batched launches in {WARM_RUNS + 1} runs")
        if groups_must is not None:
            want = {"fully_parallel": len(groups_must) * (WARM_RUNS + 1),
                    "group_parallel": 0, "non_parallel": 0}
            if [list(g) for g in groups] != groups_must or in_batch != want:
                raise AssertionError(f"planner {label}: batched groups {groups} with "
                                     f"{in_batch} batched launches in {WARM_RUNS + 1} "
                                     f"runs; the plan must form {groups_must}, one "
                                     f"kernel-1 launch each a run: {want}")
        modes = {m: sum(d.decode_mode == m for d in plan.decisions.values())
                 for m in ("whole", "batched", "chunk")}
        overheads = sorted(p_.executor.cost_model.launch_overhead_s(c) * 1e3 for c in columns)
        rec = {"modeled_makespan_ms": plan.modeled_makespan_s * 1e3,
               "makespan_ms": float(np.median(spans[1:])), "makespan_ms_cold": spans[0],
               "makespan_ms_warm_min": min(spans[1:]), "makespan_ms_warm_max": max(spans[1:]),
               "host_run_ms": float(np.median(hosts[1:])),
               "baselines_ms": {k: v * 1e3 for k, v in sorted(plan.baselines.items())},
               "window": plan.window, "modes": modes,
               # a batch is one decode unit, as its columns' records each count it
               "decode_units_per_run": sum(out[c].decode_launches for c in columns)
               - sum(len(g) - 1 for g in groups),
               "kernel_launches_per_run": sum(per_run.values()),
               "launches": counts, "batched_launches": in_batch,
               "launches_per_run": per_run, "batched_launches_per_run": batch_per_run,
               "batched_groups": [list(g) for g in groups],
               "launch_overhead_ms_min": overheads[0],
               "launch_overhead_ms_median": float(np.median(overheads)),
               "launch_overhead_ms_max": overheads[-1],
               "decode_scale": p_.executor.cost_model.decode_scale,
               "transfer_scale": p_.executor.cost_model.transfer_scale,
               "host_ms_per_added_unit": host_per_unit_ms,
               "chunked_columns": sorted(c for c, d in plan.decisions.items()
                                         if d.decode_mode == "chunk")}
        print(f"planner {label} " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in rec.items()))
        for line in plan.explain().splitlines():
            print(f"planner {label} | {line}")
        return rec

    encoded = {c: pipe.encoded(c) for c in columns}
    ref_pipe = ColumnPipeline(dict(TABLE2_PLANS), device="cuda")   # the reference's defaults
    ref_pipe.load(encoded)
    sf1 = args.scale == 1.0 and args.seed == 0     # the one same-program pair of SF 1
    planned["reference-default"] = drive_plan(ref_pipe, ref_pipe.plan(), "reference-default",
                                              [["L_DISCOUNT", "L_TAX"]] if sf1 else None)
    ref_pipe = None
    auto_pipe = ColumnPipeline(dict(TABLE2_PLANS), device="cuda", policy="adaptive",
                               chunk_bytes="auto", chunk_decode=True)
    auto_pipe.load(encoded)
    planned["adaptive-auto seeded"] = drive_plan(auto_pipe, auto_pipe.plan(),
                                                 "adaptive-auto seeded")
    planned["adaptive-auto calibrated"] = drive_plan(auto_pipe, auto_pipe.plan(),
                                                     "adaptive-auto calibrated")
    auto_pipe = None

    # ---------------------------------------------------------------- phase 6
    queries = run_queries(args, cols, encoded, timer, hbm, libs)

    # ---------------------------------------------------------------- phase 7
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
              "effective_plain_gbps": plain_b / makespan / 1e9,
              "plain_copy_ms": plain_copy_ms,
              "plain_copy_gbps": plain_b / plain_copy_ms / 1e6,
              "launches_per_run": sum(launches_warm.values())}
    for cb in CHUNK_SIZES:
        rec = chunked[f"table2 {mib(cb)}"]
        totals[f"chunked_{mib(cb)}_makespan_ms"] = rec["makespan_ms"]
        totals[f"chunked_{mib(cb)}_host_run_ms"] = rec["host_run_ms"]
        totals[f"chunked_{mib(cb)}_decode_units"] = rec["decode_units_per_run"]
        totals[f"chunked_{mib(cb)}_launches_per_run"] = rec["kernel_launches_per_run"]
    for label, rec in planned.items():
        key = label.replace(" ", "_").replace("-", "_")
        totals[f"planner_{key}_makespan_ms"] = rec["makespan_ms"]
        totals[f"planner_{key}_modeled_ms"] = rec["modeled_makespan_ms"]
        totals[f"planner_{key}_decode_units"] = rec["decode_units_per_run"]
    totals["host_ms_per_added_unit"] = host_per_unit_ms
    print("totals " + " ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                               for k, v in totals.items()))
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        mine = [r for r in stages if r["kernel"] == kname]
        big = max(mine, key=lambda r: (r["library_ms"] is not None, r["bytes"]))
        ent = max((r for r in entries if r["kernel"] == kname), key=lambda r: r["n"])
        bat = next(r for r in batched if r["kernel"] == kname and r["k"] == 2)
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": err[kname],
            "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": big["library_ms"],
            "matches_plain": True, "at": f"{big['column']}:{big['stage']}",
            "n": big["n"], "launches_per_run": launches_warm[kname],
            "main_path_ms": sum(r["ms"] for r in mine),
            "main_path_plain_ms": sum(r["plain_ms"] for r in mine),
            "main_path_bound_ms": sum(r["bound_ms"] for r in mine),
            "main_path_profiler_ms": sum(r["profiler_ms"] for r in mine),
            "chunked_launches_per_run": {k: v["launches_per_run"][kname]
                                         for k, v in chunked.items()},
            "entry": {k: ent[k] for k in ("column", "entry", "n", "ms", "whole_n",
                                          "whole_ms", "plain_ms")},
            "batched_entry": {k: bat[k] for k in ("what", "stage", "k", "launches", "n", "ms",
                                                  "singles_ms", "plain_ms", "bound_ms")},
            "batched_splits": {r["k"]: r["launches"] for r in batched if r["kernel"] == kname},
            "planner_launches_per_run": {k: v["launches_per_run"][kname]
                                         for k, v in planned.items()},
            "planner_batched_launches_per_run": {k: v["batched_launches_per_run"][kname]
                                                 for k, v in planned.items()}})
    kernels.append(queries["kernel"])
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": name, "stages": stages,
                                        "columns": rows, "totals": totals,
                                        "entries": entries, "chunked": chunked,
                                        "batched": batched, "host_split": host_split,
                                        "planner": planned, "queries": queries["runs"],
                                        "kernels": kernels},
                                       indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
