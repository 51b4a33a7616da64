"""Pipelining Layer (paper §3.3): scheduling policies over a two-machine flow shop.

Each data block i is a job with two sequential operations on two "machines":
  machine 1 = host->device link (transfer time a_i),
  machine 2 = on-device decompression (time b_i),
and blocks are independent -- a classic two-machine flow shop.  Johnson (1954) gives
the makespan-optimal order:  jobs with a_i <= b_i first, ascending a_i; then the rest,
descending b_i.  (The paper reports O(n); the textbook bound is O(n log n) for the
sort -- we note the discrepancy and implement the optimal rule.)

The module has three parts:

  * primitive orders and simulators (``johnson_order``, ``fifo_order``,
    ``makespan``, ``simulate_stream``) -- ``simulate_stream`` is the generalized
    simulator that models what the streaming executor actually does: transfer is
    always chunk-granular, decode is chunk-granular (body launches plus an uneven
    tail launch) only for columns running per-chunk decode;
  * chunk-level job expansion (``chunk_jobs`` / ``column_of`` /
    ``column_order``) used to derive column issue orders from chunk-granular
    Johnson schedules;
  * pluggable **policy objects** (``FifoPolicy``, ``JohnsonPolicy``,
    ``ChunkJohnsonPolicy``, ``AdaptivePolicy``) sharing the one simulator -- the
    planner (``core/planner.py``) scores and picks among them instead of the old
    hard-coded executor heuristics.

This module is a copy of the reference's ``core/scheduler.py`` (pure Python,
no device code), so that the port imports nothing of the reference package;
``tests/test_torch_scheduler.py`` holds every function equal to the original.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Job:
    name: str
    transfer_s: float    # machine-1 time (PCIe/host-link)
    decompress_s: float  # machine-2 time (device decode)


def johnson_order(jobs: Sequence[Job]) -> list[int]:
    """Return indices into ``jobs`` in Johnson-optimal execution order."""
    first = sorted((i for i, j in enumerate(jobs) if j.transfer_s <= j.decompress_s),
                   key=lambda i: jobs[i].transfer_s)
    second = sorted((i for i, j in enumerate(jobs) if j.transfer_s > j.decompress_s),
                    key=lambda i: -jobs[i].decompress_s)
    return first + second


def makespan(jobs: Sequence[Job], order: Sequence[int] | None = None) -> float:
    """Simulate the two-stage pipeline: transfer is serial on the link; decompression
    of block k starts when both its transfer and block k-1's decompression finish."""
    order = list(range(len(jobs))) if order is None else list(order)
    t_link = 0.0   # when the link frees up
    t_dev = 0.0    # when the device frees up
    for i in order:
        t_link += jobs[i].transfer_s
        t_dev = max(t_dev, t_link) + jobs[i].decompress_s
    return t_dev


def serial_time(jobs: Sequence[Job]) -> float:
    """No pipelining: every block transfers then decompresses exclusively."""
    return sum(j.transfer_s + j.decompress_s for j in jobs)


def brute_force_best(jobs: Sequence[Job]) -> tuple[float, tuple[int, ...]]:
    """Exhaustive optimum (testing only; factorial)."""
    best = (float("inf"), tuple(range(len(jobs))))
    for perm in itertools.permutations(range(len(jobs))):
        m = makespan(jobs, perm)
        if m < best[0]:
            best = (m, perm)
    return best


def schedule(names: Sequence[str], transfer_s: Sequence[float],
             decompress_s: Sequence[float]) -> list[str]:
    """Convenience wrapper used by the data loader: returns block names in optimal
    issue order."""
    jobs = [Job(n, a, b) for n, a, b in zip(names, transfer_s, decompress_s)]
    return [jobs[i].name for i in johnson_order(jobs)]


# ----------------------------------------------------------- chunk-level jobs

def fifo_order(jobs: Sequence[Job]) -> list[int]:
    """Submission order (the no-scheduler baseline)."""
    return list(range(len(jobs)))


CHUNK_SEP = "#"


def _escape(name: str) -> str:
    """Escape the chunk separator in a column name (``#`` -> ``##``)."""
    return name.replace(CHUNK_SEP, CHUNK_SEP * 2)


def _unescape(name: str) -> str:
    return name.replace(CHUNK_SEP * 2, CHUNK_SEP)


def chunk_jobs(jobs: Sequence[Job], n_chunks: Sequence[int],
               tail_frac: Sequence[float] | None = None) -> list[Job]:
    """Split each column job into its chunk-level jobs.

    The streaming executor transfers column ``j`` as ``n_chunks[j]`` pieces and
    -- for element-chunkable columns under per-chunk decode -- launches one
    decode per transferred chunk, so the model here is chunk-granular on BOTH
    machines: it is what ``StreamingExecutor.run(chunk_decode=True)`` executes,
    not merely an unreachable bound.  Chunk ``i`` of column ``name`` is named
    ``escape(name)#i`` (``#`` in column names is escaped as ``##`` so
    ``column_of`` inverts the naming unambiguously).

    ``tail_frac[j]`` in (0, 1] models the uneven final chunk the executor's
    aligned chunk layout produces: chunks ``0..k-2`` carry one full share each
    and the tail carries ``tail_frac`` of a share (total time is preserved).
    Default is an even split.  Finer jobs let the two-machine pipeline overlap
    *within* a column, which whole-column jobs cannot:
    makespan(chunked, Johnson) <= makespan(whole, Johnson).
    """
    out: list[Job] = []
    tails = [1.0] * len(jobs) if tail_frac is None else list(tail_frac)
    for j, k, tf in zip(jobs, n_chunks, tails):
        k = max(1, int(k))
        tf = min(1.0, max(tf, 1e-9)) if k > 1 else 1.0
        denom = (k - 1) + tf
        base = _escape(j.name)
        for i in range(k):
            w = (tf if i == k - 1 else 1.0) / denom
            out.append(Job(f"{base}{CHUNK_SEP}{i}",
                           j.transfer_s * w, j.decompress_s * w))
    return out


def column_of(chunk_name: str) -> str:
    """Invert ``chunk_jobs`` naming: 'L_ORDERKEY#3' -> 'L_ORDERKEY' (unescaping
    any ``##`` the column name's own ``#`` characters became)."""
    return _unescape(chunk_name.rsplit(CHUNK_SEP, 1)[0])


def column_order(chunk_names: Sequence[str]) -> list[str]:
    """Column issue order induced by a chunk-level schedule (first appearance).

    Johnson's rule keys only on (transfer, decompress), which are identical for every
    full chunk of one column, so a column's chunks stay (near-)contiguous and the
    induced order is the order their first chunks hit the link.
    """
    seen: set[str] = set()
    out: list[str] = []
    for cn in chunk_names:
        col = column_of(cn)
        if col not in seen:
            seen.add(col)
            out.append(col)
    return out


# ----------------------------------------------------- generalized simulator

@dataclasses.dataclass(frozen=True)
class ChunkInfo:
    """Per-column chunking configuration for ``simulate_stream``.

    ``n_chunks`` transfer pieces; ``chunk_decode`` selects per-chunk decode
    (one body launch per chunk plus the uneven ``tail_frac`` tail launch)
    versus one whole-column launch after the last chunk arrives;
    ``launch_overhead_s`` is the cost of each decode launch beyond the first.
    ``weights`` optionally replaces the uniform-body + tail split with explicit
    per-chunk (transfer, decode) fractions -- group-boundary chunks are
    genuinely uneven (data-dependent group sizes, whole-resident prologue bytes
    all ahead of span 0), so the simulator models per-chunk byte counts rather
    than assuming even splits.  Fractions are normalized per machine; ignored
    unless ``len(weights) == n_chunks``.
    """

    n_chunks: int = 1
    chunk_decode: bool = False
    tail_frac: float = 1.0
    launch_overhead_s: float = 0.0
    weights: tuple[tuple[float, float], ...] = ()


def _chunk_fractions(info: ChunkInfo, k: int) -> tuple[list[float], list[float]]:
    """Per-chunk (transfer, decode) fractions, each summing to 1."""
    w = info.weights
    if w and len(w) == k:
        ts = sum(x[0] for x in w) or 1.0
        ds = sum(x[1] for x in w) or 1.0
        return [x[0] / ts for x in w], [x[1] / ds for x in w]
    tf = min(1.0, max(info.tail_frac, 1e-9)) if k > 1 else 1.0
    denom = (k - 1) + tf
    frac = [1.0 / denom] * (k - 1) + [tf / denom]
    return frac, list(frac)


def simulate_stream(jobs: Sequence[Job],
                    infos: Sequence[ChunkInfo] | None = None,
                    order: Sequence[int] | None = None,
                    window: int | None = None) -> float:
    """Makespan of the streaming executor's actual pipeline shape.

    Transfer is serial on the link and always chunk-granular.  Decode of a
    per-chunk column launches per transferred chunk (body launches + uneven
    tail, or explicit per-chunk weights for group-boundary spans); a
    whole-decode column's single launch waits for its *last* chunk.  With
    default infos this reduces exactly to ``makespan``.

    ``window`` bounds the number of transferred-but-undecoded chunks in
    flight (the staging-buffer budget): transfer of a new per-chunk-decode
    chunk stalls until the chunk ``window`` places ahead of it has decoded
    and freed its slot (FIFO -- decode completions are monotone).  Only
    per-chunk-decode chunks hold slots; a whole-decode column's pieces go
    straight into its reassembly buffer.  ``None`` keeps the link free-running
    (unbounded staging), matching the historical model.
    """
    return simulate_stream_finish(jobs, infos, order, window)[0]


def simulate_stream_finish(jobs: Sequence[Job],
                           infos: Sequence[ChunkInfo] | None = None,
                           order: Sequence[int] | None = None,
                           window: int | None = None
                           ) -> tuple[float, list[float]]:
    """``simulate_stream`` plus per-JOB decode-completion times.

    Returns ``(makespan, finish)`` where ``finish[i]`` is the simulated time
    job ``i``'s last decode launch completes (indexed like ``jobs``, not like
    ``order``).  This is what multi-query planning needs: N interleaved
    queries share one link, and a query is done when the *latest* of its
    columns finishes -- the per-job completion vector turns one shared-link
    simulation into per-query latency estimates, so issue orders can be
    scored on tail latency as well as aggregate makespan.
    """
    order = list(range(len(jobs))) if order is None else list(order)
    infos = [ChunkInfo()] * len(jobs) if infos is None else list(infos)
    w = None if window is None else max(1, int(window))
    t_link = 0.0
    t_dev = 0.0
    job_finish = [0.0] * len(jobs)
    finish: list[float] = []  # decode completion per held chunk, transfer order
    for idx in order:
        j, info = jobs[idx], infos[idx]
        k = max(1, int(info.n_chunks))
        tw, dw = _chunk_fractions(info, k)
        if info.chunk_decode and k > 1:
            for i in range(k):
                m = len(finish)
                if w is not None and m >= w:
                    t_link = max(t_link, finish[m - w])
                t_link += j.transfer_s * tw[i]
                t_dev = (max(t_dev, t_link) + j.decompress_s * dw[i]
                         + (info.launch_overhead_s if i else 0.0))
                finish.append(t_dev)
        else:
            t_link += j.transfer_s
            t_dev = max(t_dev, t_link) + j.decompress_s
        job_finish[idx] = t_dev
    return t_dev, job_finish


def simulate_stream_multi(jobs: Sequence[Job],
                          infos: Sequence[ChunkInfo] | None = None,
                          assignment: Sequence[int] | None = None,
                          n_links: int | None = None,
                          order: Sequence[int] | None = None,
                          window: int | None = None,
                          link_scale: Sequence[float] = (),
                          link_latency_s: Sequence[float] = (),
                          host_window: int | None = None,
                          serial_issue: bool = False,
                          d2d_copies: Sequence[tuple[int, float]] | None = None
                          ) -> tuple[float, list[float]]:
    """``simulate_stream_finish`` over N independent host->device links.

    ``assignment[i]`` is the link (= device) job ``i`` streams over; every
    link is an independent machine-1 feeding its own device's machine-2, so
    the mesh pipeline is N two-machine flow shops coupled only through the
    HOST side: one staging pool (``host_window`` caps the total number of
    transferred-but-undecoded per-chunk-decode chunks in flight across ALL
    links, the shared pinned-host-buffer budget) plus per-link FIFO windows
    (``window``, same meaning as ``simulate_stream``).

    Per-link heterogeneity: ``link_scale[d]`` multiplies transfer times on
    link ``d`` (1.0 = the cost model's calibrated host link) and
    ``link_latency_s[d]`` adds a fixed per-piece issue latency -- the
    topology parameters ``CostModel.topology`` carries.

    The host issues greedily to whichever link frees up first (ties to the
    lowest link id), each link draining its jobs in ``order``'s induced
    suborder.  With one default link this reduces EXACTLY to
    ``simulate_stream_finish``.  Returns ``(makespan, finish)`` where the
    makespan is the latest device-side completion across links.

    ``serial_issue=True`` instead models the legacy one-host-thread loop the
    pre-async executor ran: link ``d``'s first piece issues only after link
    ``d-1``'s leg has fully decoded (devices serviced strictly one at a
    time), so the N flow shops degenerate into a chain.  Comparing the two
    modes on the SAME assignment prices exactly what concurrent per-device
    issuance (``run_sharded(concurrent=True)``) buys.

    ``d2d_copies`` models the REBALANCE phase of a two-tier topology: each
    ``(job_idx, copy_s)`` is a device->device copy of job ``job_idx``'s
    decoded output over the D2D fabric, ready the moment that job's decode
    finishes.  The fabric is one serial machine (NVLink-class links are
    full-duplex but a single engine drives the copies here, matching the
    executor's one-``device_put``-at-a-time issuance per leg): copies are
    processed in ready order, each extending that job's finish time, and
    they OVERLAP all remaining H2D transfers and decodes on other jobs --
    only the copied job's completion (and hence possibly the makespan)
    moves.  ``None``/empty reduces exactly to the single-tier model.
    """
    order = list(range(len(jobs))) if order is None else list(order)
    infos = [ChunkInfo()] * len(jobs) if infos is None else list(infos)
    assignment = [0] * len(jobs) if assignment is None else list(assignment)
    L = max(1, int(n_links)) if n_links is not None else \
        (max(assignment) + 1 if assignment else 1)
    scale = [float(link_scale[d]) if d < len(link_scale) else 1.0
             for d in range(L)]
    lat = [float(link_latency_s[d]) if d < len(link_latency_s) else 0.0
           for d in range(L)]
    w = None if window is None else max(1, int(window))
    hw = None if host_window is None else max(1, int(host_window))

    def rebalance(makespan: float, job_finish: list[float]
                  ) -> tuple[float, list[float]]:
        # D2D rebalance phase: one serial fabric machine, copies ready at
        # their job's decode completion, processed earliest-ready first.
        if not d2d_copies:
            return makespan, job_finish
        pend = sorted(((job_finish[i], k) for k, (i, _) in
                       enumerate(d2d_copies) if 0 <= i < len(job_finish)))
        t_fab = 0.0
        for ready, k in pend:
            i, copy_s = d2d_copies[k]
            t_fab = max(t_fab, ready) + max(0.0, float(copy_s))
            job_finish[i] = max(job_finish[i], t_fab)
        return max([makespan] + job_finish), job_finish

    # expand jobs into per-link chunk queues (transfer_s, decode_s, holds_slot)
    queues: list[list[tuple[int, float, float, bool]]] = [[] for _ in range(L)]
    for idx in order:
        j, info = jobs[idx], infos[idx]
        d = assignment[idx] % L
        k = max(1, int(info.n_chunks))
        tw, dw = _chunk_fractions(info, k)
        if info.chunk_decode and k > 1:
            for i in range(k):
                queues[d].append(
                    (idx, j.transfer_s * tw[i],
                     j.decompress_s * dw[i]
                     + (info.launch_overhead_s if i else 0.0), True))
        else:
            queues[d].append((idx, j.transfer_s, j.decompress_s, False))

    if serial_issue:
        # legacy host loop: one link at a time, chained on full decode
        t_prev = 0.0
        held_s: list[float] = []
        dev_done = [0.0] * L
        job_finish = [0.0] * len(jobs)
        for d in range(L):
            t_l = t_prev
            t_d = t_prev
            lf: list[float] = []
            for idx, ts, ds, holds in queues[d]:
                start = t_l
                if holds and w is not None and len(lf) >= w:
                    start = max(start, lf[len(lf) - w])
                if holds and hw is not None:
                    while len(held_s) >= hw:
                        start = max(start, heapq.heappop(held_s))
                t_l = start + ts * scale[d] + lat[d]
                t_d = max(t_d, t_l) + ds
                if holds:
                    lf.append(t_d)
                    if hw is not None:
                        heapq.heappush(held_s, t_d)
                job_finish[idx] = t_d
            dev_done[d] = t_d
            if queues[d]:
                t_prev = t_d
        return rebalance(max(dev_done), job_finish)

    t_link = [0.0] * L
    t_dev = [0.0] * L
    ptr = [0] * L
    # per-link decode completions of held chunks (FIFO per-link window), plus
    # one global min-heap for the shared host staging budget
    link_finish: list[list[float]] = [[] for _ in range(L)]
    held: list[float] = []
    job_finish = [0.0] * len(jobs)
    while True:
        # the host services whichever link can start its next piece earliest
        # (per-link window stalls included; the shared budget is applied after
        # the pick -- it frees in global decode-completion order either way)
        best_d, best_t = -1, float("inf")
        for d in range(L):
            if ptr[d] >= len(queues[d]):
                continue
            start = t_link[d]
            holds = queues[d][ptr[d]][3]
            if holds and w is not None:
                m = len(link_finish[d])
                if m >= w:
                    start = max(start, link_finish[d][m - w])
            if start < best_t - 1e-18:
                best_d, best_t = d, start
        if best_d < 0:
            break
        d = best_d
        idx, ts, ds, holds = queues[d][ptr[d]]
        ptr[d] += 1
        start = best_t
        if holds and hw is not None:
            # shared staging pool: stall until enough held chunks have decoded
            # (slots free at decode completion, earliest-finishing first)
            while len(held) >= hw:
                start = max(start, heapq.heappop(held))
        t_link[d] = start + ts * scale[d] + lat[d]
        t_dev[d] = max(t_dev[d], t_link[d]) + ds
        if holds:
            link_finish[d].append(t_dev[d])
            if hw is not None:
                heapq.heappush(held, t_dev[d])
        job_finish[idx] = t_dev[d]
    return rebalance(max(t_dev), job_finish)


# ------------------------------------------------------- scheduling policies

class SchedulingPolicy:
    """Order + makespan model for a set of column jobs.

    ``order`` returns column indices; ``modeled_makespan`` scores the policy's
    order under the shared ``simulate_stream`` simulator, so every policy is
    judged by the same per-chunk pipeline model.
    """

    name = "base"

    def order(self, jobs: Sequence[Job],
              infos: Sequence[ChunkInfo] | None = None) -> list[int]:
        raise NotImplementedError

    def modeled_makespan(self, jobs: Sequence[Job],
                         infos: Sequence[ChunkInfo] | None = None) -> float:
        return simulate_stream(jobs, infos, self.order(jobs, infos))


class FifoPolicy(SchedulingPolicy):
    """Submission order -- the no-scheduler baseline."""

    name = "fifo"

    def order(self, jobs, infos=None):
        return fifo_order(jobs)


class JohnsonPolicy(SchedulingPolicy):
    """Whole-column Johnson's rule (paper §3.3)."""

    name = "johnson"

    def order(self, jobs, infos=None):
        return johnson_order(jobs)


class ChunkJohnsonPolicy(SchedulingPolicy):
    """Johnson's rule at chunk granularity; the induced column order issues
    decode-heavy columns' first chunks ahead of transfer-heavy ones."""

    name = "chunk-johnson"

    def order(self, jobs, infos=None):
        if infos is None:
            return johnson_order(jobs)
        cjobs = chunk_jobs(jobs, [i.n_chunks for i in infos],
                           [i.tail_frac for i in infos])
        corder = johnson_order(cjobs)
        cols = column_order([cjobs[i].name for i in corder])
        index = {j.name: i for i, j in enumerate(jobs)}
        return [index[c] for c in cols]


class AdaptivePolicy(SchedulingPolicy):
    """Pick the best of the fixed policies *for this job set* by simulated
    makespan -- never worse than any single one under the shared model."""

    name = "adaptive"

    def __init__(self):
        self.candidates: tuple[SchedulingPolicy, ...] = (
            FifoPolicy(), JohnsonPolicy(), ChunkJohnsonPolicy())

    def order(self, jobs, infos=None):
        best, best_mk = list(range(len(jobs))), float("inf")
        for pol in self.candidates:
            order = pol.order(jobs, infos)
            mk = simulate_stream(jobs, infos, order)
            if mk < best_mk:
                best, best_mk = order, mk
        return best


POLICIES: dict[str, type[SchedulingPolicy]] = {
    p.name: p for p in (FifoPolicy, JohnsonPolicy, ChunkJohnsonPolicy,
                        AdaptivePolicy)}


def get_policy(policy: str | SchedulingPolicy) -> SchedulingPolicy:
    """Resolve a policy name (or pass an instance through)."""
    if isinstance(policy, SchedulingPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown scheduling policy {policy!r}; "
                         f"known: {sorted(POLICIES)}") from None
