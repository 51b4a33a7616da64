"""TPC-H columns through the PyTorch/CUDA port: compress on the host, plan, stream
to the device (whole, batched, or in chunks), decode, and check against the source.

Run:  PYTHONPATH=src python examples/tpch_pipeline_torch.py [--scale 0.01]
          [--chunk-kib N] [--chunk-decode] [--policy P] [--auto-chunks]
          [--device cpu]

The defaults are the reference's: ``--policy chunk-johnson`` with 1 MiB transfer
chunks.  ``--chunk-kib 0`` moves each column in one copy; a size moves every
leaf in pieces of that many KiB, and ``--chunk-decode`` decodes each chunk
(element chunk or span of whole groups) in its own launch.  ``--policy adaptive
--auto-chunks`` lets the planner choose each column's chunk size and decode
mode.  The plan is printed (``ExecutionPlan.explain``) with its modeled
makespan beside the measured one.  On a CUDA device (the default) the kernels
are built first; ``--device cpu`` runs the plain versions.

Then TPC-H Q1 and Q6 run decode-fused (``ColumnPipeline.run_query``: the
query's filter and aggregates ride the decode launches, and only partial
aggregates reach device memory) against materialize-then-query (``run``, then
the torch engine), within ``rtol`` 1e-4; each prints its selectivity, chunks
and launches, modeled traffic before and after fusion, and the columns the
planner would fuse.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.loader import ColumnPipeline
from repro_torch.data.queries import ENGINES, QUERY_PLANS
from repro_torch.data.tpch import generate

ap = argparse.ArgumentParser()
ap.add_argument("--scale", type=float, default=0.01)
ap.add_argument("--chunk-kib", type=int, default=1024)
ap.add_argument("--chunk-decode", action="store_true")
ap.add_argument("--policy", default="chunk-johnson",
                choices=("fifo", "johnson", "chunk-johnson", "adaptive"))
ap.add_argument("--auto-chunks", action="store_true",
                help="per-column chunk sizes chosen by the planner")
ap.add_argument("--device", default=None)
args = ap.parse_args()

cols = {k: v for k, v in generate(args.scale, seed=0).items() if k in TABLE2_PLANS}
pipe = ColumnPipeline(dict(TABLE2_PLANS), device=args.device,
                      chunk_bytes="auto" if args.auto_chunks else args.chunk_kib * 1024 or None,
                      chunk_decode=args.chunk_decode, policy=args.policy)
ratios = pipe.compress(cols)
plan = pipe.plan()
res = pipe.run(plan=plan)
for name, r in res.items():
    if not np.array_equal(r.array.cpu().numpy().view(np.uint8), cols[name].view(np.uint8)):
        raise SystemExit(f"{name}: decoded column differs from its source")
    print(f"{name:16s} ratio {ratios[name]:7.2f} n_chunks {r.n_chunks:4d} "
          f"decode_launches {r.decode_launches:4d} transfer_ms {r.transfer_s * 1e3:8.3f} "
          f"decode_ms {r.decode_s * 1e3:8.3f}"
          + (f" batched_with {','.join(r.batched_with)}" if r.batched_with else ""))
print(f"{len(res)} columns equal to their sources; makespan {pipe.makespan_s * 1e3:.3f} ms "
      f"({pipe.device}); decode units {sum(r.decode_launches for r in res.values())}; "
      f"programs {pipe.cache_stats}")
print(f"planned {plan.modeled_makespan_s * 1e3:.3f} ms (before the run, from the chip "
      f"model) against measured {pipe.makespan_s * 1e3:.3f} ms")
for line in plan.explain().splitlines():
    print(f"  {line}")
replan = pipe.plan()
print(f"re-planned from this run's measurements: {replan.modeled_makespan_s * 1e3:.3f} ms")
for line in replan.explain().splitlines():
    print(f"  {line}")


def sync() -> None:
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)


# decode-fused execution (late materialization): the query's operators ride the
# per-chunk decode launches, and only partial aggregates reach device memory
for q, qp in sorted(QUERY_PLANS.items()):
    names = qp.columns()
    t0 = time.perf_counter()
    res = pipe.run(order=names)
    want = ENGINES[q]({n: res[n].array for n in names})
    sync()
    t_mat = time.perf_counter() - t0
    pipe.run_query(qp)              # cold: lowers, plans and stages the query
    t0 = time.perf_counter()
    qe = pipe.run_query(qp)
    t_fused = time.perf_counter() - t0
    np.testing.assert_allclose(np.asarray(qe.result), want.cpu().numpy(), rtol=1e-4)
    ep_q = pipe.query_plan(qp)
    n_fused = sum(d.fused for d in ep_q.decisions.values())
    print(f"decode-fused Q{q}: {t_fused * 1e3:.3f} ms warm (makespan {qe.makespan_s * 1e3:.3f} ms) "
          f"against materialize-then-query "
          f"{t_mat * 1e3:.3f} ms; selectivity {qe.selectivity:.4f}; {qe.n_chunks} chunks / "
          f"{qe.decode_launches} launches; modeled traffic {qe.traffic_bytes / 1e6:.2f} MB "
          f"(before fusion {qe.prefuse_traffic_bytes / 1e6:.2f} MB); "
          f"{qe.plain_bytes / 1e6:.2f} MB of decoded rows never written; "
          f"planner fused {n_fused}/{len(names)} columns")
