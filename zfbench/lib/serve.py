"""One run of an open-loop cell (a traffic mix with ``"loop": "open"``):
independent clients' requests arrive on a schedule drawn from the seed and go
to the port's ``ServePlanner``, whatever the program has done with the ones
before.

* **The program.** ``ColumnPipeline.serve_planner(policy=<mix's policy>)``
  over the configuration's own pipeline (its executor, ``ProgramCache`` and
  ``CostModel``), ``max_wave=None``, with its background drain loop
  (``start()``): each wave registers the queued requests' columns, plans
  their union, runs one ``StreamingExecutor.run`` and unregisters them.
* **A request** is the columns of one of the mix's ``queries``; it ships
  ``Encoded`` objects of its own over the configuration's encoded buffers
  (nothing copied), so the planner registers and stages every request, as
  distinct clients' blobs are.
* **The schedule** (``schedule``): ``round(rate_per_s * seconds)`` requests,
  the queries in an even split.  The gaps between arrivals are the stratified
  quantiles of the exponential distribution (a Poisson process's gaps),
  scaled to end within the window; the seed orders the gaps, and so where the
  bursts fall, and the requests over the arrivals (and makes the data).  Every
  seed so offers the same requests and the same set of gaps, in another order:
  gaps drawn afresh moved the latency from seed to seed far more than between
  two runs of one seed.
* **The open loop.** The main thread sleeps until each scheduled arrival and
  calls ``submit``; it never waits for a completion.  A collector thread
  takes the requests in order, waits for each, and drops its decoded arrays
  unless the check keeps them.
* **A request's latency** runs from its *scheduled* arrival to its completion
  (``submitted_at + latency_s``: its last column seen decoded on the device),
  both on ``time.perf_counter``, so a late submit shows in it.
* **Warm-up**: the same open loop at the same rate, ``warmup.requests`` at
  least and then until ``warmup.quiet_requests`` requests in a row met no
  ``ProgramCache`` miss (``warmup.max_requests`` at most); it drains before
  the window starts.
* **The window** holds every request scheduled within ``--seconds``.  Then
  submitting stops; a request not done ``grace_s`` after the window's end is
  ``failed``, and so is one that carries an error.  The drain loop is then
  stopped, which serves whatever is queued.
* **The check**: ``check.sampled_requests`` requests drawn from the seed
  (reservoir sampling, the queries in turn), and every request whose wave met
  a program no earlier wave had, keep their arrays on the device; after the
  window each is compared bitwise with the source columns of its own query
  (``reference/compare.py``).  A window request that never completes, or
  whose wave raised, is ``lost_requests``.
* **The traced run** profiles the window's last ``trace.requests`` requests,
  every thread; the harness's spans
  ``drain``, ``register``, ``plan``, ``run`` and ``unregister`` wrap the
  planner's and its executor's public calls on the drain thread.  The
  program's counters of a wave (``WaveReport``) are read from the waves that
  served no profiled request.
"""
from __future__ import annotations

import dataclasses
import json
import queue
import sys
import threading
import time

import numpy as np

from zfbench.lib import harness
from zfbench.lib.trace import SPAN_PREFIX, from_profiler

WARM, WINDOW = "w", "r"          # rid prefixes of warm-up and window requests


def schedule(rate: float, n: int, span_s: float, queries, rng) -> tuple[np.ndarray, list[str]]:
    """``n`` requests: their arrival offsets in seconds (the first at 0, the
    last before ``span_s``), from the same set of gaps for every seed, and
    their queries; both orders drawn from ``rng``."""
    q = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-q) / rate)
    gaps *= span_s / gaps.sum()
    offsets = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    names = list(queries)
    kinds = [names[i % len(names)] for i in rng.permutation(n)]
    return offsets, kinds


def _rng(seed: int, stream: int):
    return np.random.default_rng([seed % 2**64, stream])


def _spanned(fn, part: str):
    import torch

    name = SPAN_PREFIX + part

    def call(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)

    return call


class Server:
    """The program under test as a serving caller drives it, and what the
    harness reads of its waves: ``missed`` holds the requests whose wave met a
    program that no earlier wave had (``ProgramCache.misses`` moved between
    the end of one ``executor.run`` and the end of the next: a wave's
    registration and its run)."""

    def __init__(self, setup, traffic: dict, spans: bool):
        from repro_torch.core.serve_planner import rid_of

        self.setup = setup
        self.columns = traffic["queries"]
        self.planner = setup.pipe.serve_planner(policy=traffic["policy"])
        ex = self.ex = self.planner.executor
        self.missed: set[str] = set()
        self._misses = ex.cache.misses
        run = ex.run

        def counted_run(*a, **kw):
            out = run(*a, **kw)
            m = ex.cache.misses
            if m != self._misses:
                self._misses = m
                self.missed.update(rid_of(n) for n in kw.get("names") or out)
            return out

        ex.run = counted_run
        if spans:
            for obj, attr, part in ((self.planner, "drain", "drain"),
                                    (ex, "compile", "register"), (ex, "plan", "plan"),
                                    (ex, "run", "run"), (ex, "unregister", "unregister")):
                setattr(obj, attr, _spanned(getattr(obj, attr), part))

    def submit(self, rid: str, query: str):
        enc = self.setup.encoded
        return self.planner.submit(rid, {c: dataclasses.replace(enc[c])
                                         for c in self.columns[query]})

    def window_waves(self, traced: set) -> list[dict]:
        """The window's waves; ``traced``: one of its requests was profiled."""
        return [{"op": "wave", "requests": len(r.rids), "register_s": r.register_s,
                 "wall_s": r.wall_s, "makespan_s": r.makespan_s,
                 "traced": not traced.isdisjoint(r.rids)}
                for r in self.planner.reports if any(i.startswith(WINDOW) for i in r.rids)]


class Loop:
    """One open loop's submissions and the collector thread that sees them
    complete.  ``done(rec, req)`` runs on the collector for each request, in
    submission order, once it completed or the deadline passed."""

    def __init__(self, server: Server, prefix: str, done):
        self.server = server
        self.prefix = prefix
        self.done = done
        self.recs: list[dict] = []
        self.deadline: float | None = None
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._collect, name="zfbench-collect",
                                        daemon=True)
        self._thread.start()

    def submit(self, i: int, query: str, due: float) -> None:
        rid = f"{self.prefix}{i}"
        req = self.server.submit(rid, query)
        rec = {"op": "request", "rid": rid, "query": query, "t0": due, "t1": None,
               "submitted": req.submitted_at, "error": None, "missed": False}
        self.recs.append(rec)
        self._q.put((rec, req))

    def _collect(self) -> None:
        while (item := self._q.get()) is not None:
            rec, req = item
            while not req.wait(0.05):
                if self.deadline is not None and time.perf_counter() >= self.deadline:
                    break
            if req.done:
                rec["t1"] = req.submitted_at + req.latency_s
                rec["error"] = None if req.error is None else repr(req.error)
                rec["missed"] = req.rid in self.server.missed
            self.done(rec, req)

    def close(self, deadline: float) -> None:
        """Wait for every submitted request, until ``deadline`` at the latest."""
        self.deadline = deadline
        self._q.put(None)
        self._thread.join()


def _wait_until(due: float) -> None:
    while (dt := due - time.perf_counter()) > 0:
        time.sleep(dt)


def warm_up(server: Server, traffic: dict, seed: int) -> dict:
    """The open loop at the cell's rate until the programs are built: blocks of
    ``warmup.requests`` requests, stopped once that many were submitted and
    the last ``quiet_requests`` completed met no program miss."""
    w, rate = traffic["warmup"], traffic["rate_per_s"]
    state = {"quiet": 0, "completed": 0, "last_miss_at": 0, "errors": 0, "late": 0}

    def done(rec, req):
        if rec["t1"] is None:
            state["late"] += 1
            return
        req.results.clear()
        state["completed"] += 1
        state["errors"] += rec["error"] is not None
        if rec["missed"]:
            state["quiet"], state["last_miss_at"] = 0, state["completed"]
        else:
            state["quiet"] += 1

    loop = Loop(server, WARM, done)
    rng = _rng(seed, 4)
    block = w["requests"]
    t0 = time.perf_counter()
    i = 0
    while i < w["max_requests"] and not (i >= block and state["quiet"] >= w["quiet_requests"]):
        if i % block == 0:
            offsets, kinds = schedule(rate, block, block / rate, traffic["queries"], rng)
            base = t0 + i / rate
        due = base + offsets[i % block]
        _wait_until(due)
        loop.submit(i, kinds[i % block], due)
        i += 1
    loop.close(time.perf_counter() + 60.0 + traffic["grace_s"])
    return {"requests": i, **state}


def profiler(cuda: bool):
    """A ``torch.profiler.profile`` (not started) that records every thread:
    the waves run on the planner's drain thread, which a profiler started on
    another thread would not see otherwise."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True))


def window(server: Server, traffic: dict, seconds: float, seed: int, trace: bool,
           cuda: bool):
    """The measured window: (request records, kept answers [(columns, {column:
    tensor})], the late requests, Trace or None, the profiler's start and stop
    seconds).  The traced slice is the window's last ``trace.requests``
    requests: the profiler starts before the
    first of them is submitted and stops once every request of the window was
    seen, so that neither its start nor its stop holds up a request before the
    slice."""
    rate = traffic["rate_per_s"]
    n = max(1, round(rate * seconds))
    offsets, kinds = schedule(rate, n, seconds, traffic["queries"], _rng(seed, 1))
    names = list(traffic["queries"])
    size = traffic["check"]["sampled_requests"]
    quota = {q: size // len(names) + (k < size % len(names)) for k, q in enumerate(names)}
    samples: dict[str, list] = {q: [] for q in names}
    seen = dict.fromkeys(names, 0)
    rng = _rng(seed, 2)
    new_program, late = [], []
    first = max(0, n - traffic["trace"]["requests"]) if trace else n
    cols = traffic["queries"]

    def done(rec, req):
        if rec["t1"] is None or rec["error"] is not None:
            late.append((rec, req))
            return
        q = rec["query"]
        answer = (cols[q], req.arrays)
        req.results.clear()
        if rec["missed"]:
            new_program.append(answer)
            return
        seen[q] += 1
        if len(samples[q]) < quota[q]:
            samples[q].append(answer)
        elif quota[q]:
            j = int(rng.integers(0, seen[q]))
            if j < quota[q]:
                samples[q][j] = answer

    prof, overhead = None, {}
    loop = Loop(server, WINDOW, done)
    start = time.perf_counter()
    for i, (off, kind) in enumerate(zip(offsets, kinds)):
        due = start + off
        if i == first:
            prof = profiler(cuda)
            t = time.perf_counter()
            prof.start()
            overhead["start_s"] = time.perf_counter() - t
        _wait_until(due)
        loop.submit(i, kind, due)
        loop.recs[-1]["traced"] = i >= first
    end = start + seconds
    _wait_until(end)
    loop.close(end + traffic["grace_s"])
    tr = None
    if prof is not None:
        t = time.perf_counter()
        prof.stop()
        overhead["stop_s"] = time.perf_counter() - t
        tr = from_profiler(prof)
    kept = new_program + [a for q in names for a in samples[q]]
    return loop.recs, kept, late, tr, overhead


def readings(plain: dict, answers: list[tuple], lost: int) -> dict:
    """Every number compared: each kept request's columns against the source
    columns of its own query, bitwise, summed; and the lost requests."""
    from zfbench.reference import compare

    out = {"missing_columns": 0, "mismatched_elements": 0,
           "missing_answers": 0 if answers else 1}
    for names, ans in answers:
        got = compare.compare_load({c: plain[c] for c in names}, [ans])
        out["missing_columns"] += got["missing_columns"]
        out["mismatched_elements"] += got["mismatched_elements"]
    out["lost_requests"] = lost
    return out


def control_answers(plain: dict, traffic: dict) -> list[tuple]:
    """The reference in the program's place, one precision lower: one answer
    of each query of the mix, its float32 columns carried in bfloat16."""
    from zfbench.reference import compare

    return [(names, compare.control_load_answer({c: plain[c] for c in names}))
            for names in traffic["queries"].values()]


def serve(setup, traffic: dict, seconds: float, seed: int, trace: bool, cuda: bool,
          hook=None) -> dict:
    """Warm-up and the window over a set-up pipeline; the planner stopped.
    ``hook`` (tests only) is called with the ``Server`` before it starts."""
    import torch

    server = Server(setup, traffic, spans=trace)
    if hook is not None:
        hook(server)
    harness.quiet_host()
    server.planner.start()
    t_warm = time.perf_counter()
    warm = warm_up(server, traffic, seed)
    warm["seconds"] = time.perf_counter() - t_warm
    if trace:                   # the profiler's first start, out of the window
        with profiler(cuda):
            torch.zeros(1, device="cuda" if cuda else "cpu").add_(1)
    t_window = time.perf_counter()
    recs, kept, late, tr, overhead = window(server, traffic, seconds, seed, trace, cuda)
    server.planner.stop()
    lost = sum(1 for rec, req in late if not req.done or req.error is not None)
    for rec, req in late:
        req.results.clear()
    traced = {r["rid"] for r in recs if r["traced"]}
    return {"recs": recs, "kept": kept, "late": len(late), "lost": lost, "trace": tr,
            "profiler_s": overhead, "waves": server.window_waves(traced), "warm": warm,
            "t_window": t_window,
            "missed_in_window": sum(r["missed"] for r in recs)}


def main(args, bench: dict, cell: dict, cfg: dict, traffic: dict, hooks: dict, cuda: bool,
         t_start: float, limit: str | None) -> int:
    """``run.py``'s open-loop branch: one run of the cell, its result line last."""
    import torch

    from zfbench.lib import registry
    from zfbench.reference import compare

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    setup = harness.build(cfg, {"calls": []}, args.seed, "cuda" if cuda else "cpu",
                          scale=args.scale if args.rehearse else None)
    if "setup" in hooks:
        hooks["setup"](setup)
    out = serve(setup, traffic, args.seconds, args.seed, bool(args.trace), cuda,
                hook=hooks.get("serve"))
    setup_s = out["t_window"] - t_start

    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    found = harness.jax_loaded()
    if found:
        print(f"zfbench: the window closed with {found} loaded; the benchmark runs the "
              f"PyTorch port alone", file=sys.stderr)
        return 4
    counted = harness.count_bytes(setup)
    answers = [(names, {c: t.cpu().numpy() for c, t in ans.items()})
               for names, ans in out.pop("kept")]
    harness.free(setup, cuda)
    readings_ = readings(setup.plain, answers, out["lost"])
    correct = compare.within(readings_)

    recs, tr = out["recs"], out["trace"]
    run = harness.Run(workload=args.workload, config=cfg, traffic=traffic, device_kind=kind,
                      setup_s=setup_s, window_s=args.seconds, calls=recs + out["waves"],
                      trace=tr, counted=counted)
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
    failed = sum(r["t1"] is None or r["error"] is not None for r in recs)
    result = {"correct": correct, "attempted": len(recs), "failed": failed,
              "metrics": metrics, "device": device}
    if tr is not None:
        if cuda:
            device["busy_s"] = tr.busy_s
            device["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    late_ms = [(r["submitted"] - r["t0"]) * 1e3 for r in recs]
    lat_ms = [(r["t1"] - r["t0"]) * 1e3 for r in recs if r["t1"] is not None]
    waves = out["waves"]
    result["setup_parts_s"] = {**setup.parts_s, "warm_up": out["warm"]["seconds"]}
    result["warm_up"] = out["warm"]
    result["window"] = {
        "rate_per_s": traffic["rate_per_s"], "waves": len(waves),
        "late_or_errored": out["late"], "met_new_program": out["missed_in_window"],
        "checked_requests": len(answers), "profiler_s": out["profiler_s"],
        "request_ms": {p: float(np.percentile(lat_ms, q)) for p, q in
                       (("p50", 50), ("p95", 95), ("max", 100))} if lat_ms else None,
        "submit_late_ms": {p: float(np.percentile(late_ms, q)) for p, q in
                           (("p50", 50), ("p99", 99), ("max", 100))},
        "wave_ms_p50": float(np.median([w["wall_s"] for w in waves])) * 1e3 if waves else None}
    result["checks"] = {k: {"value": v, "limit": compare.LIMITS[k]}
                        for k, v in readings_.items()}
    for k, v in readings_.items():
        print(f"check {k} {v!r} limit {compare.LIMITS[k]!r}", file=sys.stderr)
    print(f"check correct {correct}", file=sys.stderr)
    print(json.dumps(result))
    return 0
