#!/usr/bin/env python3
"""End-to-end A/B of the port's streaming pipeline between two trees on one GPU.

    python3 scripts/pipeline_ab.py --baseline TREE [--pairs N] [--scale S]
                                   [--warm-runs N] [--chunk-kib N] [--chunk-decode]

Each run is a fresh process that imports one tree's ``repro_torch`` (this
checkout, or ``TREE``: another checkout, e.g. the parent commit unpacked beside
this one), builds its kernels into that tree, generates TPC-H at ``--scale``
(seed 0), compresses the 24 Table-2 columns and runs ``ColumnPipeline.run()``
once cold and ``--warm-runs`` times warm, every column checked against its
source.  It prints the median warm makespan (CUDA events) and host time of
``run``.  The sides alternate baseline, change, change, baseline, ... for
``--pairs`` pairs, and a summary line gives each side's medians.

Without ``--chunk-kib`` (or with 0) the pipeline gets no chunk arguments, so a
tree from before chunked streaming runs the same whole-column path.
"""
from __future__ import annotations

import argparse
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
    chunking = ({"chunk_bytes": args.chunk_kib << 10, "chunk_decode": args.chunk_decode}
                if args.chunk_kib else {})
    pipe = ColumnPipeline(dict(TABLE2_PLANS), device="cuda", **chunking)
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
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return 0
    if args.baseline is None:
        ap.error("--baseline is required")
    trees = {"baseline": args.baseline.resolve(), "change": ROOT}
    flags = [f"--scale={args.scale}", f"--warm-runs={args.warm_runs}",
             f"--chunk-kib={args.chunk_kib}"] + (["--chunk-decode"] * args.chunk_decode)
    got: dict[str, list[dict]] = {"baseline": [], "change": []}
    for i in range(args.pairs):
        for side in (("baseline", "change") if i % 2 == 0 else ("change", "baseline")):
            env = dict(os.environ, PYTHONPATH=str(trees[side] / "src"))
            run = subprocess.run([sys.executable, __file__, "--worker", *flags],
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
