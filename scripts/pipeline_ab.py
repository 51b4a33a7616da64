#!/usr/bin/env python3
"""End-to-end A/B of the port's streaming pipeline between two trees on one GPU.

    python3 scripts/pipeline_ab.py --baseline TREE [--pairs N] [--scale S]
                                   [--warm-runs N] [--chunk-kib N] [--chunk-decode]
                                   [--query Q]
    python3 scripts/pipeline_ab.py --async-dispatch [--pairs N] [...]

Each run is a fresh process that imports one tree's ``repro_torch`` (this
checkout, or ``TREE``: another checkout, e.g. the parent commit unpacked beside
this one), builds its kernels into that tree, generates TPC-H at ``--scale``
(seed 0), compresses the 24 Table-2 columns and runs ``ColumnPipeline.run()``
once cold and ``--warm-runs`` times warm, every column checked against its
source.  It prints the median warm makespan (CUDA events) and host time of
``run``.  The sides alternate baseline, change, change, baseline, ... for
``--pairs`` pairs, and a summary line gives each side's medians.

Without ``--chunk-kib`` (or with 0) the pipeline gets no chunk arguments, so a
tree from before chunked streaming runs the same whole-column path; a tree with
the planner gets ``policy="fifo"``, ``batch_columns=False`` (and
``chunk_bytes=None`` unless ``--chunk-kib`` is given), its FIFO path.  With
``--query Q`` only the columns TPC-H query Q reads are compressed and run
(``data.tpch.QUERY_COLUMNS``; the decode that materialize-then-query pays).

With ``--async-dispatch`` (and no ``--baseline``) the two sides are this tree
with the inline issuer and this tree with the dispatch engine's transfer thread
(``ColumnPipeline(async_dispatch=True)``), alternating as above.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def worker(args) -> None:
    import torch
    from repro_torch.data.columns import TABLE2_PLANS
    from repro_torch.data.loader import ColumnPipeline
    from repro_torch.data.tpch import generate

    cols = {k: v for k, v in generate(args.scale, seed=0).items() if k in TABLE2_PLANS}
    if args.query:
        from repro_torch.data.tpch import QUERY_COLUMNS
        cols = {k: cols[k] for k in QUERY_COLUMNS[args.query]}
    chunking = ({"chunk_bytes": args.chunk_kib << 10, "chunk_decode": args.chunk_decode}
                if args.chunk_kib else {})
    if "policy" in inspect.signature(ColumnPipeline).parameters:
        # a tree with the planner: its FIFO path without batching, as before it
        chunking = {"chunk_bytes": None, **chunking, "policy": "fifo",
                    "batch_columns": False}
    if args.async_side:
        chunking["async_dispatch"] = True
    pipe = ColumnPipeline({k: p for k, p in TABLE2_PLANS.items() if k in cols}, device="cuda",
                          **chunking)
    pipe.compress(cols)
    makespans, host_ms = [], []
    for _ in range(1 + args.warm_runs):
        res = None                  # a warm run reuses the last run's memory
        t0 = time.perf_counter()
        res = pipe.run()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        makespans.append(pipe.makespan_s * 1e3)
        for name, r in res.items():
            if not torch.equal(r.array.cpu().view(torch.uint8),
                               torch.from_numpy(cols[name]).view(torch.uint8)):
                raise AssertionError(f"{name}: decoded column differs from its source")
    print(json.dumps({"makespan_ms": float(np.median(makespans[1:])),
                      "host_run_ms": float(np.median(host_ms[1:])),
                      "makespan_ms_cold": makespans[0], "makespans_ms": makespans[1:]}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=False)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--warm-runs", type=int, default=10)
    ap.add_argument("--chunk-kib", type=int, default=0)
    ap.add_argument("--chunk-decode", action="store_true")
    ap.add_argument("--query", type=int, default=0, help="only TPC-H query Q's columns")
    ap.add_argument("--async-dispatch", action="store_true",
                    help="compare this tree's inline issuer with its transfer thread")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--async-side", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return 0
    if args.async_dispatch:
        if args.baseline is not None:
            ap.error("--async-dispatch compares two modes of this tree: no --baseline")
        trees = {"inline": ROOT, "async": ROOT}
    elif args.baseline is None:
        ap.error("--baseline is required")
    else:
        trees = {"baseline": args.baseline.resolve(), "change": ROOT}
    a, b = trees
    flags = [f"--scale={args.scale}", f"--warm-runs={args.warm_runs}",
             f"--chunk-kib={args.chunk_kib}", f"--query={args.query}"] + (["--chunk-decode"] * args.chunk_decode)
    got: dict[str, list[dict]] = {a: [], b: []}
    for i in range(args.pairs):
        for side in ((a, b) if i % 2 == 0 else (b, a)):
            env = dict(os.environ, PYTHONPATH=str(trees[side] / "src"))
            run = subprocess.run([sys.executable, __file__, "--worker", *flags]
                                 + ["--async-side"] * (side == "async"),
                                 env=env, cwd=trees[side], capture_output=True, text=True)
            if run.returncode:
                sys.stderr.write(run.stderr)
                raise SystemExit(f"{side} run failed with code {run.returncode}")
            rec = json.loads(run.stdout.strip().splitlines()[-1])
            got[side].append(rec)
            print(f"{side:8s} makespan_ms {rec['makespan_ms']:.4f} host_run_ms "
                  f"{rec['host_run_ms']:.4f} cold_ms {rec['makespan_ms_cold']:.4f} "
                  f"warm {' '.join(f'{t:.3f}' for t in rec['makespans_ms'])}", flush=True)
    print("summary " + " ".join(
        f"{side}_makespan_ms {np.median([r['makespan_ms'] for r in recs]):.4f} "
        f"{side}_host_run_ms {np.median([r['host_run_ms'] for r in recs]):.4f}"
        for side, recs in got.items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
