"""Multi-query serving planner: one transfer queue, N concurrent requests.

The reference's ``core/serve_planner.py`` on one device.  A serving system has
many concurrent requests contending for one host->device link and one card:
the link is a shared machine 1, the device a shared machine 2, and every
request's columns are jobs in one two-machine flow shop.

  * **Shared transfer queue.** ``submit`` queues a request's columns under
    rid-namespaced names (``"<rid>/<col>"``); ``drain`` plans one execution
    over the union of the pending requests' columns and runs it as one
    ``StreamingExecutor.run`` (a *wave*), so cross-column pipelining spans
    request boundaries.  Identical ``Encoded`` objects submitted by different
    requests decode once and fan out.
  * **Cross-request batching.** Structural signatures are request-agnostic,
    so whole-mode columns of one signature from different requests are marked
    ``batched`` and decode in one launch per stage of the kernels' batched
    entries; clustered candidate orders put them next to each other (the
    executor batches adjacent columns only).
  * **Issue ordering.** Candidate orders (the union's adaptive plan, naive
    per-query FIFO composition, greedy marginal makespan over request
    permutations, SLO hoisting, clustered variants) are scored with
    ``scheduler.simulate_stream_finish``, which gives per-request completion
    times too.  The naive composition is a candidate, so the shared plan's
    simulated makespan is never above it (except under ``slo``).
  * **Latency against throughput.** ``policy="shared"`` minimizes the
    makespan; ``policy="slo"`` minimizes the point class's worst finish first
    and lets a point request submitted during a wave cut in at the next unit,
    chunk or span boundary (the executor's ``preempt`` hook runs it as a
    nested wave); ``policy="fifo-per-query"`` is the naive baseline.

Each wave's measured actuals feed the shared ``CostModel``; per-request names
are unregistered after the wave (their pinned host staging with them), while
the per-signature history survives, so wave N+1 plans from wave N's
calibration.  A request's latency is taken when its last column's decode is
complete on the device (the executor's ``on_ready``).

``mesh=N`` (N > 1) spreads each wave over N devices: the wave's columns are
re-planned by ``planner.plan_mesh_execution`` (at the wave plan's window,
under ``placement`` when given) and run by ``StreamingExecutor.run_sharded``;
a mesh wave takes no preemption (point requests cut in between waves), and
its report carries the devices, their decode units and any D2D copies.

``ServePlanner()`` without an executor builds one for the card and raises
when CUDA is absent.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Mapping, Sequence

import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core import planner as planner_mod
from repro_torch.core import scheduler
from repro_torch.core.executor import ColumnExec, StreamingExecutor
from repro_torch.core.planner import ColumnDecision, ExecutionPlan
from repro_torch.core.scheduler import ChunkInfo

SEP = "/"           # rid-namespace separator: "<rid>/<col>"

POINT, BULK = "point", "bulk"


def qualify(rid, col: str) -> str:
    """The executor's name for one request's column."""
    return f"{rid}{SEP}{col}"


def rid_of(qname: str) -> str:
    """Invert ``qualify`` (rids must not contain ``/``; column names may)."""
    return qname.split(SEP, 1)[0]


@dataclasses.dataclass
class ServeRequest:
    """One submitted request: a set of compressed columns wanted on the device."""

    rid: str
    encs: dict[str, plan_mod.Encoded]
    klass: str = BULK                   # "bulk" | "point" (SLO class)
    submitted_at: float = 0.0           # perf_counter at submit
    results: dict[str, ColumnExec] = dataclasses.field(default_factory=dict)
    done: bool = False
    latency_s: float = 0.0              # submit -> last column decoded on the device
    modeled_finish_s: float = 0.0       # simulated finish under the chosen plan
    preempted_in: bool = False          # served by a preemptive nested wave
    # a wave's failure lands here, per request, not in the draining thread
    error: BaseException | None = None
    _done_evt: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)

    @property
    def arrays(self) -> dict[str, torch.Tensor]:
        return {c: r.array for c, r in self.results.items()}

    def wait(self, timeout: float | None = None) -> bool:
        """Block until this request is served (or its wave failed); True once
        ``done``.  The completion signal of the background drain loop."""
        return self._done_evt.wait(timeout)

    def _finish(self, error: BaseException | None = None) -> None:
        if error is not None and self.error is None:
            self.error = error
        self.done = True
        self._done_evt.set()


@dataclasses.dataclass
class WaveReport:
    """Accounting for one wave (one shared ``executor.run``).  Besides the
    reference's fields: ``register_s``, the host time of registering the
    wave's columns (programs, schedules and pinned staging), with
    ``register_split_s`` its parts (``StreamingExecutor.register_split_s``),
    and ``makespan_s``, the run's makespan on the device (CUDA events on a
    card; of a mesh wave, its longest leg's)."""

    rids: tuple[str, ...]
    policy: str
    chosen: str                          # the winning candidate's label
    order: tuple[str, ...]
    window: int
    shared_makespan_s: float             # chosen plan, shared simulator
    naive_makespan_s: float              # per-query FIFO composition, same model
    candidates: dict[str, float]         # label -> simulated makespan
    modeled_finish_s: dict[str, float]   # rid -> simulated completion
    naive_finish_s: dict[str, float]     # rid -> completion under the naive order
    wall_s: float = 0.0
    decode_launches: int = 0
    cross_batched_saved: int = 0         # launches removed by cross-rid batching
    preempted: int = 0                   # point requests served mid-wave
    devices: tuple[int, ...] = ()        # mesh waves: the device ids spanned
    device_launches: dict[int, int] = dataclasses.field(default_factory=dict)
    # mesh waves: the redistribution legs run, item -> (src id, dst id, seconds)
    d2d_copies: dict[str, tuple[int, int, float]] = dataclasses.field(default_factory=dict)
    register_s: float = 0.0
    register_split_s: dict[str, float] = dataclasses.field(default_factory=dict)
    makespan_s: float = 0.0


class ServePlanner:
    """Shared-resource planner over one ``StreamingExecutor`` (its device, or
    with ``mesh`` several).

    ``submit`` is thread-safe (concurrent producers share one queue and one
    ProgramCache); ``drain`` runs waves until the queue is empty and returns
    every request served; ``start``/``stop`` run the same waves on a
    background thread.  ``max_wave`` bounds how many requests one wave
    composes (None: all pending)."""

    def __init__(self, executor: StreamingExecutor | None = None,
                 policy: str = "shared", max_wave: int | None = None,
                 mesh: int | None = None, placement: str | None = None):
        if policy not in ("shared", "slo", "fifo-per-query"):
            raise ValueError(f"unknown serve policy {policy!r}; known: "
                             "shared, slo, fifo-per-query")
        if executor is None:
            if not torch.cuda.is_available():
                raise RuntimeError("ServePlanner builds a CUDA executor by default and no "
                                   "CUDA device is available; pass an executor (e.g. "
                                   "ColumnPipeline(plans, device='cpu').serve_planner())")
            executor = StreamingExecutor(backend="kernel", device="cuda")
        self.executor = executor
        self.policy = policy
        self.max_wave = max_wave
        # mesh=N: waves span N devices; placement="sharded" pins each shard's
        # final device (the planner may land it elsewhere and copy it over)
        self.mesh = mesh
        self.placement = placement
        self._lock = threading.Lock()
        self._pending: deque[ServeRequest] = deque()
        self._served: deque[ServeRequest] = deque()   # preemptive completions
        self._in_wave = False
        self._last_preempted = 0
        self.reports: list[WaveReport] = []
        # the drain loop (start/stop): _wave_mutex serializes waves between
        # the background thread and explicit drain() callers -- the
        # executor's registries and its launches are single-threaded
        self._wave_mutex = threading.RLock()
        self._arrival = threading.Event()
        self._stop_evt = threading.Event()
        self._drain_thread: threading.Thread | None = None

    # ------------------------------------------------------------- admission
    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def submit(self, rid, encs: Mapping[str, plan_mod.Encoded],
               klass: str = BULK) -> ServeRequest:
        """Enqueue a request (thread-safe).  Decode happens at ``drain``."""
        rid = str(rid)
        if SEP in rid:
            raise ValueError(f"rid {rid!r} must not contain {SEP!r}")
        req = ServeRequest(rid=rid, encs=dict(encs), klass=klass,
                           submitted_at=time.perf_counter())
        with self._lock:
            if any(r.rid == rid for r in self._pending):
                raise ValueError(f"rid {rid!r} already pending")
            self._pending.append(req)
        self._arrival.set()     # wake the background drain loop, if running
        return req

    # ----------------------------------------------------------------- drain
    def drain(self) -> dict[str, ServeRequest]:
        """Serve every pending request; returns ``{rid: request}``.

        One wave runs at a time (``_wave_mutex``).  A wave that raises
        attaches the exception to each of its requests (``req.error``) and
        draining goes on: submitters see failures per request."""
        done: dict[str, ServeRequest] = {}
        with self._wave_mutex:
            while True:
                with self._lock:
                    # requests a preemptive nested wave completed surface here
                    while self._served:
                        req = self._served.popleft()
                        done[req.rid] = req
                    if not self._pending:
                        break
                    n = len(self._pending) if self.max_wave is None \
                        else min(self.max_wave, len(self._pending))
                    wave = [self._pending.popleft() for _ in range(n)]
                try:
                    report = self._run_wave(wave)
                except Exception as e:
                    for req in wave:
                        req._finish(e)
                        done[req.rid] = req
                    continue
                self.reports.append(report)
                for req in wave:
                    done[req.rid] = req
        return done

    # ------------------------------------------------------ the drain loop
    def start(self, poll_s: float = 0.05) -> "ServePlanner":
        """Start the drain loop: a background thread forms a wave from whatever
        is queued each time the executor goes idle, so ``submit`` alone
        completes requests (block on ``req.wait()``); ``drain()`` still works
        and runs the next wave on the caller's thread.  Idempotent."""
        with self._lock:
            if self._drain_thread is not None and self._drain_thread.is_alive():
                return self
            self._stop_evt.clear()
            self._drain_thread = threading.Thread(
                target=self._drain_loop, args=(poll_s,),
                name="zipflow-serve-drain", daemon=True)
            self._drain_thread.start()
        return self

    def stop(self, wait: bool = True) -> None:
        """Stop the drain loop.  Waves in flight complete, and anything
        submitted before ``stop`` is still served (one final sweep)."""
        t = self._drain_thread
        self._stop_evt.set()
        self._arrival.set()
        if wait and t is not None and t is not threading.current_thread():
            t.join(timeout=120.0)
        self._drain_thread = None

    def _drain_loop(self, poll_s: float = 0.05) -> None:
        while not self._stop_evt.is_set():
            self._arrival.wait(timeout=poll_s)
            self._arrival.clear()
            if self._stop_evt.is_set():
                break
            if self.pending:
                self.drain()
        if self.pending:        # final sweep: pre-stop submissions complete
            self.drain()

    # ------------------------------------------------------------ preemption
    def _preempt(self) -> None:
        """The executor's ``preempt`` hook under ``policy="slo"``: newly
        arrived point requests cut in at the next unit, chunk or span boundary
        of the running wave, through a nested wave on the same executor."""
        if self._in_wave:
            urgent: list[ServeRequest] = []
            with self._lock:
                for req in list(self._pending):
                    if req.klass == POINT:
                        self._pending.remove(req)
                        urgent.append(req)
            if urgent:
                self._in_wave = False          # nested waves must not recurse
                try:
                    report = self._run_wave(urgent, preemptive=True)
                finally:
                    self._in_wave = True
                self.reports.append(report)
                with self._lock:
                    for req in urgent:
                        req.preempted_in = True
                        self._served.append(req)
                self._last_preempted += len(urgent)

    # ------------------------------------------------------------- wave core
    def _run_wave(self, reqs: Sequence[ServeRequest],
                  preemptive: bool = False) -> WaveReport:
        ex = self.executor
        t_wave0 = time.perf_counter()
        # register the union; identical Encoded objects shipped by several
        # requests share one decode (the result fans out)
        primary: dict[int, str] = {}
        encs: dict[str, plan_mod.Encoded] = {}
        owners: dict[str, list[tuple[ServeRequest, str]]] = {}
        req_names: dict[str, list[str]] = {r.rid: [] for r in reqs}
        for req in reqs:
            for col, enc in req.encs.items():
                qn = qualify(req.rid, col)
                p = primary.get(id(enc))
                if p is None:
                    primary[id(enc)] = p = qn
                    encs[qn] = enc
                    owners[qn] = []
                owners[p].append((req, col))
                if p not in req_names[req.rid]:
                    req_names[req.rid].append(p)
        for qn in encs:
            if qn in ex._encoded:
                raise ValueError(f"{qn!r} is already registered (in-flight wave?): "
                                 "rids must be unique across concurrent waves")
        registered: list[str] = []
        split0 = dict(ex.register_split_s)
        try:
            for qn, enc in encs.items():
                ex.compile(qn, enc)
                registered.append(qn)
            register_s = time.perf_counter() - t_wave0
            ep, report = self._plan_wave(reqs, list(encs), req_names)
            report.register_s = register_s
            report.register_split_s = {k: v - split0[k]
                                       for k, v in ex.register_split_s.items()}
            ready_at: dict[str, float] = {}

            def on_ready(name: str) -> None:
                ready_at[name] = time.perf_counter()

            use_mesh = (self.mesh or 0) > 1 and not preemptive
            # a mesh wave trades unit-boundary preemption for its legs: point
            # requests still cut in between waves
            use_preempt = self.policy == "slo" and not preemptive and not use_mesh
            if not preemptive:       # nested waves must not clobber the count
                self._last_preempted = 0
            self._in_wave = use_preempt
            try:
                if use_mesh:
                    profiles = {n: ex.column_profile(n) for n in encs}
                    mesh_ep = planner_mod.plan_mesh_execution(
                        profiles, ex.cost_model, n_devices=int(self.mesh), window=ep.window,
                        placement=self.placement)
                    report.chosen = f"mesh:{mesh_ep.policy}"
                    report.candidates["mesh"] = mesh_ep.modeled_makespan_s
                    report.shared_makespan_s = mesh_ep.modeled_makespan_s
                    report.devices = tuple(sorted(mesh_ep.device_ids))
                    mres = ex.run_sharded(mesh_ep, on_ready=on_ready)
                    results = mres.columns
                    report.device_launches = dict(mres.device_launches)
                    report.d2d_copies = dict(mres.d2d_copies)
                    report.makespan_s = max(mres.leg_makespan_s.values(), default=0.0)
                else:
                    results = ex.run(names=list(encs), plan=ep,
                                     preempt=self._preempt if use_preempt else None,
                                     on_ready=on_ready)
                    report.makespan_s = ex.last_makespan_s
            finally:
                self._in_wave = False
            report.wall_s = time.perf_counter() - t_wave0
            report.preempted = 0 if preemptive else self._last_preempted

            # fan the results out (aliased columns share the decoded tensor)
            for qn, rec in results.items():
                for req, col in owners[qn]:
                    req.results[col] = rec
            for req in reqs:
                t_ready = max((ready_at[p] for p in req_names[req.rid] if p in ready_at),
                              default=time.perf_counter())
                req.latency_s = t_ready - req.submitted_at
                req.modeled_finish_s = report.modeled_finish_s.get(
                    req.rid, report.shared_makespan_s)
                req._finish()

            # launch accounting: a batched group of k columns is one decode
            # unit; cross_batched_saved counts the units a per-query execution
            # would have needed on top (one per further rid in a group)
            seen: set[frozenset] = set()
            launches = saved = 0
            for qn, rec in results.items():
                if rec.batched_with:
                    g = frozenset((qn,) + rec.batched_with)
                    if g in seen:
                        continue
                    seen.add(g)
                    launches += 1
                    rids = {rid_of(n) for n in g}
                    if len(rids) > 1:
                        saved += len(rids) - 1
                else:
                    launches += rec.decode_launches
            report.decode_launches = launches
            report.cross_batched_saved = saved
            return report
        finally:
            for qn in registered:
                ex.unregister(qn)

    # ---------------------------------------------------------- wave planning
    def _plan_wave(self, reqs: Sequence[ServeRequest], names: list[str],
                   req_names: dict[str, list[str]]
                   ) -> tuple[ExecutionPlan, WaveReport]:
        """Score candidate issue orders under the shared-link simulator and
        build the winning ``ExecutionPlan``.  The naive per-query FIFO
        composition is always a candidate, so the chosen makespan never
        exceeds it (except under ``slo``, which trades makespan for the point
        class's tail latency; both numbers are reported)."""
        ex = self.executor
        cm = ex.cost_model
        idx = {n: i for i, n in enumerate(names)}
        sig_of = {n: ex.graph(n).signature for n in names}

        # the union's adaptive plan: chunk configurations x fifo/johnson/
        # chunk-johnson searched over all requests' columns at once
        ep_u = ex.plan(names, policy="adaptive")
        jobs = cm.jobs(names)
        overhead = {n: cm.launch_overhead_s(n) for n in names}

        def infos_of(decisions: Mapping[str, ColumnDecision]) -> list[ChunkInfo]:
            return [ChunkInfo(
                n_chunks=max(1, decisions[n].n_chunks),
                chunk_decode=decisions[n].decode_mode == planner_mod.CHUNK,
                tail_frac=decisions[n].tail_frac,
                launch_overhead_s=overhead[n],
                weights=decisions[n].weights) for n in names]

        # per-request plans: what each query would do for itself; their
        # concatenation in submission order is the naive per-query FIFO server
        per_req_order: dict[str, list[str]] = {}
        merged_dec: dict[str, ColumnDecision] = {}
        for req in reqs:
            rnames = req_names[req.rid]
            if not rnames:               # fully deduplicated against earlier requests
                per_req_order[req.rid] = []
                continue
            ep_r = ex.plan(rnames, policy="adaptive")
            per_req_order[req.rid] = [n for n in ep_r.order if n in idx]
            merged_dec.update({n: ep_r.decisions[n] for n in rnames})
        naive_order = [n for req in reqs for n in per_req_order[req.rid]]

        def cluster(order: Sequence[str],
                    decisions: Mapping[str, ColumnDecision]) -> list[str]:
            """Pull batched columns of one signature next to each other
            (stable): the executor merges adjacent batched columns only."""
            placed: set[str] = set()
            out: list[str] = []
            for n in order:
                if n in placed:
                    continue
                out.append(n)
                placed.add(n)
                if decisions[n].decode_mode == planner_mod.BATCHED:
                    for m in order:
                        if (m not in placed and sig_of[m] == sig_of[n]
                                and decisions[m].decode_mode == planner_mod.BATCHED):
                            out.append(m)
                            placed.add(m)
            return out

        def mark_batched(decisions: dict[str, ColumnDecision]) -> None:
            """Cross-request batching: whole-mode columns of one structural
            signature decode in one batched launch when adjacent."""
            by_sig: dict[str, list[str]] = {}
            for n, d in decisions.items():
                if d.decode_mode in (planner_mod.WHOLE, planner_mod.BATCHED) \
                        and not d.fused:
                    by_sig.setdefault(sig_of[n], []).append(n)
            for ns in by_sig.values():
                mode = planner_mod.BATCHED if len(ns) > 1 else planner_mod.WHOLE
                for n in ns:
                    decisions[n] = dataclasses.replace(decisions[n], decode_mode=mode)

        union_dec = dict(ep_u.decisions)
        mark_batched(union_dec)
        mark_batched(merged_dec)

        # greedy marginal-makespan request permutation: place next the request
        # whose columns grow the composed makespan least
        merged_infos = infos_of(merged_dec)

        def composed_mk(prefix: list[str]) -> float:
            return scheduler.simulate_stream(
                jobs, merged_infos, [idx[n] for n in prefix], ep_u.window)

        remaining = list(reqs)
        greedy_order: list[str] = []
        while remaining:
            best_req, best_mk = None, float("inf")
            for req in remaining:
                mk = composed_mk(greedy_order + per_req_order[req.rid])
                if mk < best_mk - 1e-15:
                    best_req, best_mk = req, mk
            greedy_order += per_req_order[best_req.rid]
            remaining.remove(best_req)

        # SLO hoisting: the point requests' columns first (in submission
        # order), the bulk after
        points = [r for r in reqs if r.klass == POINT]
        bulks = [r for r in reqs if r.klass != POINT]
        slo_order = [n for r in points + bulks for n in per_req_order[r.rid]]

        candidates: dict[str, tuple[list[str], dict[str, ColumnDecision]]] = {
            "shared-union": (list(ep_u.order), union_dec),
            "shared-union-clustered": (cluster(ep_u.order, union_dec), union_dec),
            "fifo-per-query": (naive_order, merged_dec),
            "greedy-marginal": (greedy_order, merged_dec),
            "greedy-clustered": (cluster(greedy_order, merged_dec), merged_dec),
        }
        if points and bulks:
            candidates["slo-hoist"] = (slo_order, merged_dec)

        scored: dict[str, tuple[float, list[float]]] = {}
        for label, (order, dec) in candidates.items():
            scored[label] = scheduler.simulate_stream_finish(
                jobs, infos_of(dec), [idx[n] for n in order], ep_u.window)

        def req_finish(fin: list[float]) -> dict[str, float]:
            return {r.rid: max((fin[idx[n]] for n in req_names[r.rid]), default=0.0)
                    for r in reqs}

        naive_mk, naive_fin = scored["fifo-per-query"]
        if self.policy == "fifo-per-query":
            chosen = "fifo-per-query"
        elif self.policy == "slo" and points:
            # lexicographic: the worst point-class finish, then the makespan
            def key(label):
                mk, fin = scored[label]
                rf = req_finish(fin)
                return (max((rf[r.rid] for r in points), default=0.0), mk)
            chosen = min(scored, key=key)
        else:
            chosen = min(scored, key=lambda label: scored[label][0])

        order, decisions = candidates[chosen]
        mk, fin = scored[chosen]
        plan = ExecutionPlan(
            order=tuple(order), decisions=dict(decisions),
            policy=f"serve-{self.policy}:{chosen}", window=ep_u.window,
            modeled_makespan_s=mk,
            baselines={lbl: s[0] for lbl, s in scored.items()})
        report = WaveReport(
            rids=tuple(r.rid for r in reqs), policy=self.policy, chosen=chosen,
            order=tuple(order), window=ep_u.window,
            shared_makespan_s=mk, naive_makespan_s=naive_mk,
            candidates={lbl: s[0] for lbl, s in scored.items()},
            modeled_finish_s=req_finish(fin),
            naive_finish_s=req_finish(naive_fin))
        return plan, report
