"""Run one cell of the benchmark once, and print its result as the last line.

    python3 zfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic and
its metrics are found by name from ``BENCHMARK.json`` (``zfbench/README.md``).
The run generates the cell's TPC-H columns from the seed, encodes them with
the port (``repro_torch``), stages them in a ``ColumnPipeline`` on the card,
warms up, and then drives the traffic for ``--seconds`` as one closed-loop
client, or, for a mix with ``"loop": "open"``, as requests on a schedule into
the port's ``ServePlanner`` (``lib/serve.py``).  ``--trace 0`` prints the
cell's end-to-end metrics; ``--trace 1`` traces a slice of the window with
``torch.profiler`` and prints its per-layer metrics.  Either way the answers
are compared with the NumPy reference once the window has closed; each number
compared is printed beside its limit, on standard error and under ``checks``
in the result.

It exits non-zero and prints no result without enough CUDA devices, if JAX
or the JAX package was loaded, or if the program is absent.

``--rehearse`` runs the same path on the CPU at a tiny scale (``--scale``)
with the port's plain PyTorch backend; every metric it prints is prefixed
``cpu_rehearsal.``, since no CPU number stands for a device metric.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def _cache_dirs() -> None:
    """Every build and kernel cache of the program at a fixed path inside the
    checkout, so that only a checkout's first run builds."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at --scale with the plain PyTorch backend")
    ap.add_argument("--scale", type=float, default=0.01,
                    help="TPC-H scale factor of a rehearsal (ignored otherwise)")
    return ap.parse_args(argv)


def main(argv=None, hooks=None) -> int:
    """``hooks["setup"]`` (tests only) is called with the set-up, to plant a
    fault in the pipeline under test; ``hooks["serve"]``, with an open-loop
    cell's ``serve.Server``."""
    args = parse(argv)
    from zfbench.lib import registry

    bench = registry.benchmark(ROOT)
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"], ROOT)
    traffic = registry.traffic(cell["traffic"])
    hooks = hooks or {}

    _cache_dirs()
    import torch

    cuda = not args.rehearse
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        print(f"zfbench: {args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if traffic.get("loop") == "open":       # requests on a schedule: lib/serve.py
        from zfbench.lib import serve

        return serve.main(args, bench, cell, cfg, traffic, hooks, cuda, T_START,
                          _power_limit() if cuda else None)
    from zfbench.lib import harness
    from zfbench.reference import compare

    device = "cuda" if cuda else "cpu"
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    limit = _power_limit() if cuda else None
    setup = harness.build(cfg, traffic, args.seed, device,
                          scale=args.scale if args.rehearse else None)
    if "setup" in hooks:
        hooks["setup"](setup)
    client = harness.Client(setup, traffic, cuda=cuda, spans=bool(args.trace))
    harness.quiet_host()
    t_warm = time.perf_counter()
    warm_calls, shapes, warm_last_new = harness.warm_up(client, traffic)
    warm_s = time.perf_counter() - t_warm
    setup_s = time.perf_counter() - T_START
    recs, kept, trace = harness.window(client, traffic, args.seconds, args.seed,
                                       bool(args.trace), shapes)
    window_s = recs[-1]["t1"] - recs[0]["t0"]

    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    found = harness.jax_loaded()
    if found:
        print(f"zfbench: the window closed with {found} loaded; the benchmark runs the "
              f"PyTorch port alone", file=sys.stderr)
        return 4
    counted = harness.count_bytes(setup)
    checked_loads = sum(isinstance(a, dict) for a in kept)
    answers = harness.host_answers(kept)
    kept = None
    queries = sorted(setup.queries)
    harness.free(setup, cuda)

    readings = compare.readings(setup.plain, answers,
                                loads=any(r["op"] == "load" for r in recs), queries=queries)
    correct = compare.within(readings)

    run = harness.Run(workload=args.workload, config=cfg, traffic=traffic, device_kind=kind,
                      setup_s=setup_s, window_s=window_s, calls=recs, trace=trace,
                      counted=counted)
    metrics = {}
    for m in registry.cell_metrics(bench, args.workload, per_layer=bool(args.trace)):
        value = registry.metric_reader(m["name"])(run, m["name"])
        if value is None:
            continue
        name = m["name"] if cuda else f"cpu_rehearsal.{m['name']}"
        metrics[name] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": cell["chips"], "memory_peak_bytes": peak}
    if limit:
        device["name_power_limit"] = limit
    result = {"correct": correct, "attempted": len(recs), "failed": 0,
              "metrics": metrics, "device": device}
    if trace is not None:
        if cuda:
            device["busy_s"] = trace.busy_s
            device["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["setup_parts_s"] = {**setup.parts_s, "warm_up": warm_s, "warm_calls": warm_calls,
                               "warm_last_new_shape_at": warm_last_new}
    result["checked_loads"] = checked_loads
    result["window_new_shapes"] = len(set().union(*(r["shape"] for r in recs)) - shapes)
    result["medians_ms"] = harness.medians_ms(recs)
    result["checks"] = {k: {"value": v, "limit": compare.LIMITS[k]} for k, v in readings.items()}
    for k, v in readings.items():
        print(f"check {k} {v!r} limit {compare.LIMITS[k]!r}", file=sys.stderr)
    print(f"check correct {correct}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
