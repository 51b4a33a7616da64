#!/usr/bin/env python3
"""Mesh serving waves on one GPU: sequential against concurrent legs.

    python3 scripts/mesh_wave_ab.py [--pairs N] [--scale S] [--mesh N]

Generates TPC-H at ``--scale`` (seed 0), compresses the 24 Table-2 columns
and serves a closed mix (the columns of Q1, Q6 and Q13, twice) through one
serving pipeline (``chunk_bytes="auto"``, ``chunk_decode=True``, adaptive),
each request shipping its own shallow copies of the blobs.  Three kinds of
wave take turns: ``serve_planner("shared", mesh=N)`` with its legs run
sequentially (``seq``) or concurrently (``conc``: ``run_sharded`` asked for
``concurrent=True``), and a non-mesh wave (``nonmesh``).  One cold wave of
each comes first; then ``--pairs`` rounds, the order reversed every other
round.  Every served column is checked bitwise against its source.  Each
wave prints its wall, registration, makespan (events) and host ms of
``run_sharded``; a summary gives the medians and the rounds the sequential
wave won.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

KEYS = ("wall_ms", "register_ms", "makespan_ms", "run_sharded_ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--mesh", type=int, default=2)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no GPU", file=sys.stderr)
        return 1
    from repro_torch.data.columns import TABLE2_PLANS
    from repro_torch.data.loader import ColumnPipeline
    from repro_torch.data.tpch import QUERY_COLUMNS, generate

    cols = {k: v for k, v in generate(args.scale, seed=0).items() if k in TABLE2_PLANS}
    pipe = ColumnPipeline(dict(TABLE2_PLANS), device="cuda", chunk_bytes="auto",
                          chunk_decode=True, policy="adaptive")
    pipe.compress(cols)
    encoded = {c: pipe.encoded(c) for c in TABLE2_PLANS}
    ex = pipe.executor
    run_sharded = ex.run_sharded
    mix = [QUERY_COLUMNS[1], QUERY_COLUMNS[6], QUERY_COLUMNS[13]] * 2
    truth = {c: torch.from_numpy(cols[c]).cuda() for names in mix for c in names}
    host = {"s": 0.0}

    def wave(kind: str) -> dict:
        host["s"] = 0.0
        if kind != "nonmesh":
            def timed(*a, **kw):
                t = time.perf_counter()
                try:
                    return run_sharded(*a, concurrent=kind == "conc", **kw)
                finally:
                    host["s"] += time.perf_counter() - t
            ex.run_sharded = timed
        planner = pipe.serve_planner("shared", mesh=1 if kind == "nonmesh" else args.mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [planner.submit(f"w{i}", {c: copy.copy(encoded[c]) for c in names})
                for i, names in enumerate(mix)]
        planner.drain()
        wall = time.perf_counter() - t0
        for r in reqs:
            if r.error is not None:
                raise RuntimeError(f"{kind} {r.rid}: {r.error!r}")
            for c, rec in r.results.items():
                arr = rec.array if isinstance(rec.array, torch.Tensor) else rec.array.full()
                if not torch.equal(arr, truth[c]):
                    raise AssertionError(f"{kind} {r.rid}: {c} differs from its source")
        return {"wall_ms": wall * 1e3,
                "register_ms": sum(r.register_s for r in planner.reports) * 1e3,
                "makespan_ms": sum(r.makespan_s for r in planner.reports) * 1e3,
                "run_sharded_ms": host["s"] * 1e3,
                "chosen": [r.chosen for r in planner.reports]}

    for kind in ("nonmesh", "seq", "conc"):
        print("cold", kind, json.dumps(wave(kind)), flush=True)
    got: dict[str, list] = {"seq": [], "conc": [], "nonmesh": []}
    for rnd in range(args.pairs):
        order = ("seq", "conc", "nonmesh") if rnd % 2 == 0 else ("nonmesh", "conc", "seq")
        for kind in order:
            got[kind].append(wave(kind))
            print(rnd, kind, json.dumps(got[kind][-1]), flush=True)
    summary = {kind: {k: float(np.median([r[k] for r in rs])) for k in KEYS}
               for kind, rs in got.items()}
    summary["seq_wins"] = {k: sum(s[k] < c[k] for s, c in zip(got["seq"], got["conc"]))
                           for k in KEYS if k != "register_ms"}
    summary["pairs"] = args.pairs
    print("summary", json.dumps(summary))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
