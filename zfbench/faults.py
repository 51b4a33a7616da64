"""Drive a whole run on the CPU with the timed path broken underneath, for
the tests that see ``correct`` come out false (``test_zfbench_faults_*.py``).
A cell held out of ``BENCHMARK.json`` (``zfbench/held/``) runs as well.

Each fault is planted in the pipeline after set-up, where the answer is
produced: a load's decoded columns, a query's accumulator and result; in an
open-loop cell, each request's decoded columns, or one request the serving
planner never completes."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import sys
from unittest import mock

import torch

from zfbench.lib import harness


def _load_fault(pipe, kind: str) -> None:
    run = pipe.run

    def broken(*a, **kw):
        out = run(*a, **kw)
        fixed = {}
        for i, (name, rec) in enumerate(out.items()):
            arr = rec.array.clone()
            if kind == "unchanged":          # the output buffers never written
                arr.zero_()
            elif kind == "half":             # the second half left out, the first copied
                h = arr.numel() // 2
                arr[h:2 * h] = arr[:h]
            elif kind == "altered" and i == 0:
                arr.view(-1)[arr.numel() // 3] += 1
            fixed[name] = dataclasses.replace(rec, array=arr)
        return fixed

    pipe.run = broken


def _query_fault(pipe, kind: str, setup) -> None:
    run_query = pipe.run_query
    if kind == "half":                      # half the rows, the sums scaled back up
        from repro_torch.core.plan import encode

        half = {n: encode(pipe.plans[n], a[:a.size // 2]) for n, a in setup.plain.items()}
        pipe.load(half)

    def broken(qplan, *a, **kw):
        out = run_query(qplan, *a, **kw)
        acc = out.acc.clone()
        if kind == "unchanged":
            acc.zero_()
        elif kind == "half":
            acc *= 2
        elif kind == "altered":
            acc[-1] += 1                    # one count lane off by one
        fq, _ = pipe.lower_query(qplan)
        return dataclasses.replace(out, acc=acc, result=fq.finalize(acc.cpu().numpy()))

    pipe.run_query = broken


def _serve_fault(server, kind: str) -> None:
    from repro_torch.core.serve_planner import ServeRequest, rid_of

    from zfbench.lib.serve import WINDOW

    if kind == "lost":                      # one window request queued nowhere
        submit, lost = server.planner.submit, []

        def dropped(rid, encs, *a, **kw):
            if rid.startswith(WINDOW) and not lost:
                lost.append(rid)
                return ServeRequest(rid=rid, encs=dict(encs))
            return submit(rid, encs, *a, **kw)

        server.planner.submit = dropped
        return
    run = server.ex.run

    def broken(*a, **kw):
        out = run(*a, **kw)
        fixed, seen = {}, set()
        for name, rec in out.items():
            arr = rec.array.clone()
            if kind == "unchanged":          # the output buffers never written
                arr.zero_()
            elif kind == "altered" and rid_of(name) not in seen:
                arr.view(-1)[arr.numel() // 3] += 1      # one element of a request's column
            seen.add(rid_of(name))
            fixed[name] = dataclasses.replace(rec, array=arr)
        return fixed

    server.ex.run = broken


def run_with_fault(workload: str, kind: str | None, seed: int = 5, scale: float = 0.002,
                   seconds: float = 0.3) -> dict:
    """One rehearsed run of ``workload`` with fault ``kind`` planted (None: a
    sound run); its last line, parsed."""
    from zfbench import run as runner

    def plant(setup):
        if any(c["op"] == "query" for c in setup_traffic["calls"]):
            _query_fault(setup.pipe, kind, setup)
        else:
            _load_fault(setup.pipe, kind)

    from zfbench.lib import registry

    bench = registry.with_held(registry.benchmark())
    setup_traffic = registry.traffic(registry.cell(bench, workload)["traffic"])
    hooks = {}
    if kind is not None and setup_traffic.get("loop") == "open":
        hooks["serve"] = lambda server: _serve_fault(server, kind)
    elif kind is not None:
        hooks["setup"] = plant
    env = dict(os.environ)
    threads = torch.get_num_threads()
    out = io.StringIO()
    # other tests of the same process may have imported JAX: the run's own
    # check counts only what the run itself loads
    before = {m.split(".")[0] for m in sys.modules}
    own = lambda: sorted(({m.split(".")[0] for m in sys.modules} - before)
                         & harness.JAX_MODULES)
    traffic, benchmark = registry.traffic, registry.benchmark

    def short_warm_up(name, *a, **kw):      # a few calls warm the CPU's plain backend
        data = traffic(name, *a, **kw)
        if data.get("loop") == "open":       # a few requests, at a rate the CPU serves;
            # the grace covers waves slowed by a busy host, so only a request
            # that never completes is late
            return {**data, "rate_per_s": 4.0, "grace_s": 10.0,
                    "warmup": {"requests": 6, "quiet_requests": 2, "max_requests": 30}}
        return {**data, "warmup": {"min_calls": 2, "stable_calls": 2, "max_calls": 6}}

    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()), \
                mock.patch.object(harness, "jax_loaded", own), \
                mock.patch.object(registry, "traffic", short_warm_up), \
                mock.patch.object(registry, "benchmark",
                                  lambda *a, **kw: registry.with_held(benchmark(*a, **kw))):
            rc = runner.main(["--workload", workload, "--seed", str(seed), "--seconds",
                              str(seconds), "--trace", "0", "--rehearse", "--scale", str(scale)],
                             hooks=hooks)
    finally:
        gc.unfreeze()
        os.environ.clear()
        os.environ.update(env)
        torch.set_num_threads(threads)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
