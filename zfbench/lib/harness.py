"""One run of one cell: set-up, warm-up, the measured window, the check.

The traffic file's ``calls`` are cycled by one closed-loop client: the next
call starts when the previous one has returned and the device has finished
(``torch.cuda.synchronize``).  Two kinds of call reach the program:

* ``load``: ``ColumnPipeline.plan()`` then ``ColumnPipeline.run(plan=...)``
  over every column of the configuration (the harness's spans ``plan`` and
  ``run``);
* ``query``: ``ColumnPipeline.run_query(<the port's QueryPlan of that name>)``
  (span ``run_query``).

Each call leaves a small record (its host times, the program's counters);
the answers to check are kept aside: every query's accumulator and result;
the decoded columns of every load whose plan met a shape (a column's chunk
size and decode mode) that no call before it had met; and those of
``check.sampled_loads`` more loads drawn from the seed (reservoir sampling
over the window).  Nothing is compared before the window has closed, the
peak memory has been read and the pipeline is freed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import sys
import time

import numpy as np

from zfbench.lib import peaks
from zfbench.lib import queries as query_files
from zfbench.lib import registry
from zfbench.lib.encode import encode_columns
from zfbench.lib.trace import SPAN_PREFIX, Trace, from_profiler

JAX_MODULES = {"jax", "jaxlib", "flax", "repro"}


@dataclasses.dataclass
class Setup:
    plain: dict                 # column -> source array (the reference's input)
    encoded: dict               # column -> the port's Encoded blob
    pipe: object                # the ColumnPipeline under test
    queries: dict               # query name -> the port's QueryPlan
    parts_s: dict               # set-up seconds by part


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    workload: str
    config: dict
    traffic: dict
    device_kind: str
    setup_s: float
    window_s: float
    calls: list[dict]
    trace: Trace | None
    counted: dict               # bytes counted from the benchmark's data

    def of(self, op: str) -> list[dict]:
        return [c for c in self.calls if c["op"] == op]


def config_columns(cfg: dict) -> list[str]:
    return [c for cols in cfg["tables"].values() for c in cols]


def build(cfg: dict, traffic: dict, seed: int, device, scale: float | None = None) -> Setup:
    """Generate the columns from the seed, encode them (the deployment's
    offline step), and stage them in the configuration's pipeline."""
    from repro_torch.data import columns as plan_sets
    from repro_torch.data.loader import ColumnPipeline

    from zfbench.data.tpch_gen import iter_columns

    names = config_columns(cfg)
    plans = {c: getattr(plan_sets, cfg["plans"])[c] for c in names}
    gen = iter_columns(cfg["scale_factor"] if scale is None else scale, seed, names)
    plain, encoded, parts = encode_columns(gen, plans)
    t1 = time.perf_counter()
    pipe = ColumnPipeline(plans, device=device, **cfg["pipeline"])
    t2 = time.perf_counter()
    parts["pipeline"] = t2 - t1
    pipe.load(encoded)
    parts["load"] = time.perf_counter() - t2
    wanted = {c["query"] for c in traffic["calls"] if c["op"] == "query"}
    qplans = {q: query_files.plan(registry.query(q)) for q in sorted(wanted)}
    return Setup(plain, encoded, pipe, qplans, parts)


class Client:
    """The closed-loop client over a set-up pipeline."""

    def __init__(self, setup: Setup, traffic: dict, cuda: bool, spans: bool):
        shape = (traffic.get("loop"), traffic.get("clients"), traffic.get("order"))
        if shape != ("closed", 1, "cycle"):
            raise ValueError(f"traffic {traffic['name']}: this driver runs one closed-loop "
                             f"client cycling its calls, not {shape}")
        self.s = setup
        self.traffic = traffic
        self.cuda = cuda
        self.spans = spans
        import torch

        self.torch = torch

    def _span(self, part: str):
        if not self.spans:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function(SPAN_PREFIX + part)

    def _sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def call(self, spec: dict) -> tuple[dict, object]:
        """One call: its record and its answer."""
        pipe = self.s.pipe
        ex = pipe.executor
        if spec["op"] == "load":
            t0 = time.perf_counter()
            with self._span("plan"):
                plan = pipe.plan()
            with self._span("run"):
                out = pipe.run(plan=plan)
            self._sync()
            t1 = time.perf_counter()
            units, batches = 0, set()
            for r in out.values():
                if r.batched_with:
                    batches.add(tuple(sorted((r.name, *r.batched_with))))
                else:
                    units += r.decode_launches
            shape = frozenset((n, d.chunk_bytes, d.decode_mode)
                              for n, d in plan.decisions.items())
            rec = {"op": "load", "t0": t0, "t1": t1,
                   "plain_bytes": sum(r.plain_bytes for r in out.values()),
                   "columns": len(out), "decode_units": units + len(batches),
                   "issue_s": ex.last_issue_s, "makespan_s": ex.last_makespan_s,
                   "shape": shape}
            return rec, {n: r.array for n, r in out.items()}
        if spec["op"] == "query":
            qplan = self.s.queries[spec["query"]]
            t0 = time.perf_counter()
            with self._span("run_query"):
                out = pipe.run_query(qplan)
            self._sync()
            t1 = time.perf_counter()
            rec = {"op": "query", "query": spec["query"], "t0": t0, "t1": t1,
                   "n_chunks": out.n_chunks, "makespan_s": out.makespan_s,
                   "shape": frozenset({(spec["query"], out.n_chunks)})}
            return rec, (spec["query"], out.acc, np.asarray(out.result))
        raise ValueError(f"no such call {spec['op']!r} in traffic {self.traffic['name']}")


def warm_up(client: Client, traffic: dict) -> tuple[int, set, int]:
    """Cycle the calls until no new shape (a column's chunk size and decode
    mode, as the planner chose them; a query's chunk count) has shown for
    ``stable_calls`` calls: the stagings and kernels the window meets are then
    built.  Returns the calls made, the shapes seen, and the call (counted
    from 1) that met the last new one."""
    w = traffic["warmup"]
    seen, quiet, n, last_new = set(), 0, 0, 0
    for spec in itertools.cycle(traffic["calls"]):
        rec, _ = client.call(spec)
        n += 1
        if rec["shape"] - seen:
            quiet, last_new = 0, n
        else:
            quiet += 1
        seen |= rec["shape"]
        if (n >= w["min_calls"] and quiet >= w["stable_calls"]
                and n % len(traffic["calls"]) == 0) or n >= w["max_calls"]:
            break
    return n, seen, last_new


def window(client: Client, traffic: dict, seconds: float, seed: int, trace: bool,
           seen: set):
    """The measured window: (records, answers kept, Trace or None).  ``seen``
    holds the shapes met before it; a load that meets another has its answer
    kept."""
    import torch

    keep = traffic["check"]["sampled_loads"]
    rng = np.random.default_rng([seed % 2**64, 2])
    t_cfg = traffic["trace"]
    seen = set(seen)
    recs, loads, new_shape, queries = [], [], [], []
    prof, traced, done = None, 0, not trace
    n_load = 0
    start = time.perf_counter()
    for spec in itertools.cycle(traffic["calls"]):
        now = time.perf_counter()
        if not done and prof is None and now - start >= t_cfg["skip_s"] \
                and recs and spec is traffic["calls"][0]:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if client.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        rec, answer = client.call(spec)
        recs.append(rec)
        if prof is not None and not done:
            rec["traced"] = True
            traced += 1
            if traced >= t_cfg["calls"]:
                prof.stop()
                done = True
        if rec["op"] != "load":
            queries.append(answer)
        elif rec["shape"] - seen:          # a load that met a new shape: kept
            new_shape.append(answer)
        else:                              # a reservoir sample of the other loads' answers
            n_load += 1
            if len(loads) < keep:
                loads.append(answer)
            else:
                j = int(rng.integers(0, n_load))
                if j < keep:
                    loads[j] = answer
        seen |= rec["shape"]
        answer = None
        if rec["t1"] - start >= seconds:
            break
    if prof is not None and not done:
        prof.stop()
    tr = from_profiler(prof) if prof is not None else None
    return recs, new_shape + loads + queries, tr


def quiet_host() -> None:
    """The host as one client of the card runs it: one intra-op thread (the
    window's host work is the program's Python and launches), and every
    object of set-up moved out of the garbage collector's way."""
    import torch

    torch.set_num_threads(1)
    gc.collect()
    gc.freeze()


def medians_ms(recs: list[dict]) -> dict:
    """Per-call medians, in ms, for reading a run's spread: wall time, and the
    program's makespan and issue time where it reports them."""
    out = {"call": float(np.median([r["t1"] - r["t0"] for r in recs])) * 1e3}
    for key in ("makespan_s", "issue_s"):
        vals = [r[key] for r in recs if r.get(key) is not None]
        if vals:
            out[key[:-2]] = float(np.median(vals)) * 1e3
    return out


def jax_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & JAX_MODULES)


def host_answers(kept: list) -> list:
    """The kept answers on the host, as NumPy."""
    out = []
    for a in kept:
        if isinstance(a, dict):
            out.append({n: t.cpu().numpy() for n, t in a.items()})
        else:
            q, acc, res = a
            out.append((q, acc.cpu().numpy(), res))
    return out


def count_bytes(setup: Setup) -> dict:
    """Bytes of each column, counted from the benchmark's data."""
    return {"compressed": {n: peaks.leaf_bytes(e) for n, e in setup.encoded.items()},
            "plain": {n: int(a.nbytes) for n, a in setup.plain.items()}}


def free(setup: Setup, cuda: bool) -> None:
    import torch

    setup.pipe = None
    setup.encoded = {}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
