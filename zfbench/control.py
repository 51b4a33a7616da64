"""Read the comparison's numbers for the program and for its control, seed by
seed, at a cell's own size: the readings each limit in
``reference/compare.py`` is set between.

    python3 zfbench/control.py --workload <name> --seeds 1,2,3 [--seconds 3]
                               [--control-only]

For each seed it builds the cell as a run does, warms up, drives the
traffic for ``--seconds`` and compares every kept answer (the program's
readings); then it puts the reference, computed one precision lower, in the
program's place and compares that (the control's readings).  One JSON line a
seed.  ``--control-only`` generates the data and reads the control alone.  A
cell held out of ``BENCHMARK.json`` (``zfbench/held/``) is found too.  An
open-loop cell (``lib/serve.py``) serves its window at the mix's rate for
the program's readings, and compares one request of each query for the
control's.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-only", action="store_true")
    args = ap.parse_args(argv)

    from zfbench import run as runner
    from zfbench.data.tpch_gen import generate
    from zfbench.lib import harness, registry
    from zfbench.reference import compare

    runner._cache_dirs()
    import torch

    bench = registry.with_held(registry.benchmark(ROOT))
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"], ROOT)
    traffic = registry.traffic(cell["traffic"])
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    if traffic.get("loop") == "open":
        return _open_loop(args, cfg, traffic)
    scale = cfg["scale_factor"]
    queries = sorted({c["query"] for c in traffic["calls"] if c["op"] == "query"})
    loads = any(c["op"] == "load" for c in traffic["calls"])

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed}
        if args.control_only:
            plain = generate(scale, seed, harness.config_columns(cfg))
        else:
            setup = harness.build(cfg, traffic, seed, "cuda")
            client = harness.Client(setup, traffic, cuda=True, spans=False)
            _, shapes, _ = harness.warm_up(client, traffic)
            recs, kept, _ = harness.window(client, traffic, args.seconds, seed, False, shapes)
            answers = harness.host_answers(kept)
            kept = None
            plain = setup.plain
            harness.free(setup, True)
            line["calls"] = len(recs)
            line["program"] = compare.readings(plain, answers, loads, queries)
            answers = None
        control = []
        if loads:
            control.append(compare.control_load_answer(plain))
        control += compare.control_query_answers(plain, queries)
        line["control"] = compare.readings(plain, control, loads, queries)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


def _open_loop(args, cfg: dict, traffic: dict) -> int:
    from zfbench.data.tpch_gen import generate
    from zfbench.lib import harness, serve

    used = sorted({c for cols in traffic["queries"].values() for c in cols})
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed}
        if args.control_only:
            plain = generate(cfg["scale_factor"], seed, used)
        else:
            setup = harness.build(cfg, {"calls": []}, seed, "cuda")
            out = serve.serve(setup, traffic, args.seconds, seed, False, True)
            answers = [(names, {c: t.cpu().numpy() for c, t in ans.items()})
                       for names, ans in out.pop("kept")]
            plain = setup.plain
            harness.free(setup, True)
            line["requests"] = len(out["recs"])
            line["program"] = serve.readings(plain, answers, out["lost"])
            answers = None
        line["control"] = serve.readings(plain, serve.control_answers(plain, traffic), 0)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
