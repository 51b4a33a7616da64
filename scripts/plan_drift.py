"""The call-to-call drift of what the planner prices, over warm loads of a
benchmark cell: the measurement ``planner.REPLAN_DRIFT`` is set from.

    python3 scripts/plan_drift.py --workload <cell> --seed <n> [--warm 100]
        [--calls 300] [--rehearse --scale S]

Sets the cell up as ``zfbench/run.py`` does (its configuration, seed and
pipeline), makes ``--warm`` back-to-back loads (``plan()`` + ``run()``, each
synchronized), then ``--calls`` more, and before each of these reads what
``StreamingExecutor.plan`` is about to price: each column's predicted
``transfer_s + decode_s`` (``CostModel.jobs``) and ``CostModel.decode_scale``.
It prints one JSON line:

* ``times_drift`` / ``scale_drift``: percentiles of the call-to-call
  relative distances (the L1 distance of the per-column vector over its sum;
  ``|delta decode_scale| / decode_scale``), and ``drift`` of the larger of
  the two;
* ``column_share``: the largest columns' median shares of the vector's sum
  (a 2x change of a column of share s moves the distance by s).

On a card it needs CUDA; ``--rehearse`` runs the port's plain backend on the
CPU at ``--scale``.  It imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

PCTS = (50, 75, 90, 95, 99, 100)


def pcts(x) -> dict:
    return {f"p{q}": float(np.percentile(x, q)) for q in PCTS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--warm", type=int, default=100)
    ap.add_argument("--calls", type=int, default=300)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--scale", type=float, default=0.01)
    args = ap.parse_args(argv)
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR", str(ROOT / "build" / "repro_torch_ext"))
    import torch

    from zfbench.lib import harness, registry

    bench = registry.benchmark(ROOT)
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"], ROOT)
    traffic = registry.traffic(cell["traffic"])
    cuda = not args.rehearse
    setup = harness.build(cfg, traffic, args.seed, "cuda" if cuda else "cpu",
                          scale=args.scale if args.rehearse else None)
    pipe = setup.pipe
    cm = pipe.executor.cost_model
    harness.quiet_host()
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def load():
        plan = pipe.plan()
        pipe.run(plan=plan)
        sync()
        return plan

    for _ in range(max(args.warm, 1)):
        names = list(load().decisions)
    vecs, scales = [], []
    for _ in range(args.calls):
        vecs.append([j.transfer_s + j.decompress_s for j in cm.jobs(names)])
        scales.append(cm.decode_scale)
        load()
    vecs, scales = np.asarray(vecs), np.asarray(scales)
    d_t = np.abs(np.diff(vecs, axis=0)).sum(axis=1) / vecs[:-1].sum(axis=1)
    d_s = np.abs(np.diff(scales)) / scales[:-1]
    shares = np.median(vecs / vecs.sum(axis=1, keepdims=True), axis=0)
    top = sorted(zip(names, shares), key=lambda kv: -kv[1])[:5]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "warm": args.warm, "calls": args.calls,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "times_drift": pcts(d_t), "scale_drift": pcts(d_s),
        "drift": pcts(np.maximum(d_t, d_s)),
        "column_share": [[n, float(v)] for n, v in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
