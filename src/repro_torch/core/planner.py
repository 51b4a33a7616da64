"""Holistic execution planner (the paper's central thesis as a subsystem).

``plan_execution`` turns per-column ``ColumnProfile``s + a ``CostModel`` + a
scheduling policy into an ``ExecutionPlan``: per column a chunk size (per-column,
not one global knob), a decode mode (whole-column / per-chunk / batched-by-
signature), plus a global issue order and in-flight window -- all chosen by
minimizing the modeled makespan under ``scheduler.simulate_stream``, the same
per-chunk simulator every policy is scored with.

The executor *consumes* plans (``StreamingExecutor.run(plan=...)``): planning is
fully separated from execution, and measured actuals flow back into the
``CostModel`` so the next plan is built from calibrated predictions.

With ``policy="adaptive"`` the planner searches chunk configurations
{per-column auto, all whole-column, global fixed} crossed with the candidate
issue orders, so its simulated makespan is by construction <= min(FIFO,
whole-column Johnson, fixed-chunk Johnson) under the shared model -- those
baselines are also reported in ``ExecutionPlan.baselines`` for benchmarks.

This is the reference's ``core/planner.py`` up to the mesh planner
(``plan_mesh_execution``, ``ShardSpec`` and ``MeshExecutionPlan`` come with the
multi-GPU slice); ``tests/test_torch_planner.py`` holds its plans equal to the
reference's on the same profiles and cost model.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.core import scheduler
from repro_torch.core.costmodel import ColumnProfile, CostModel
from repro_torch.core.scheduler import ChunkInfo, SchedulingPolicy, get_policy

DEFAULT_CHUNK_BYTES = 1 << 20
# legacy fixed ladder (64 KiB .. 4 MiB), kept only as the fallback when a
# column's geometry-tied ladder is empty (e.g. profiles with no tile info);
# ``CostModel.chunk_ladder`` supplies the real candidates: element chunks
# snapped to kernel tile multiples, group chunks snapped to group-boundary
# prefix sums, both pruned by the calibrated launch-overhead estimate
CHUNK_CANDIDATES = (1 << 16, 1 << 18, 1 << 20, 1 << 22)
MIN_CHUNK_BYTES = 1 << 12

WHOLE, CHUNK, BATCHED = "whole", "chunk", "batched"


@dataclasses.dataclass(frozen=True)
class ColumnDecision:
    """Planned treatment of one column."""

    name: str
    chunk_bytes: int | None       # transfer/decode chunk size for THIS column
    n_chunks: int                 # decode chunks (chunk mode) / transfer pieces
    decode_mode: str              # "whole" | "chunk" | "batched"
    tail_frac: float = 1.0
    est_transfer_s: float = 0.0
    est_decode_s: float = 0.0
    # per-chunk (transfer, decode) fractions for uneven group spans; () = uniform
    weights: tuple[tuple[float, float], ...] = ()
    # decode-fused query execution: operators ride the decode launch and only
    # partial aggregates reach HBM (vs. materialize-then-query)
    fused: bool = False
    selectivity: float = 1.0


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The explainable artifact the executor consumes: order + per-column
    decisions + in-flight window + the modeled makespan they were chosen by."""

    order: tuple[str, ...]
    decisions: Mapping[str, ColumnDecision]
    policy: str
    window: int
    modeled_makespan_s: float
    baselines: Mapping[str, float] = dataclasses.field(default_factory=dict)

    def explain(self) -> str:
        """Human-readable plan: why each column is treated the way it is."""
        lines = [f"plan: policy={self.policy} window={self.window} "
                 f"modeled_makespan={self.modeled_makespan_s * 1e3:.3f}ms"]
        for ref, mk in sorted(self.baselines.items()):
            lines.append(f"  baseline {ref:14s} {mk * 1e3:.3f}ms")
        for i, name in enumerate(self.order):
            d = self.decisions[name]
            cb = "whole" if d.chunk_bytes is None else f"{d.chunk_bytes >> 10}KiB"
            mode = f"{d.decode_mode}+fused" if d.fused else d.decode_mode
            lines.append(
                f"  {i:2d}. {name:20s} mode={mode:13s} chunk={cb:>8s} "
                f"n_chunks={d.n_chunks:3d} "
                f"pred=({d.est_transfer_s * 1e3:.3f}ms,"
                f"{d.est_decode_s * 1e3:.3f}ms)"
                + (f" sel={d.selectivity:.3f}" if d.fused else ""))
        return "\n".join(lines)


def _chunk_info(d: ColumnDecision, overhead_s: float) -> ChunkInfo:
    return ChunkInfo(n_chunks=max(1, d.n_chunks),
                     chunk_decode=d.decode_mode == CHUNK,
                     tail_frac=d.tail_frac, launch_overhead_s=overhead_s,
                     weights=d.weights)


def _chunk_decision(p: ColumnProfile, t: float, d: float,
                    chunk_bytes: int) -> ColumnDecision | None:
    """CHUNK-mode decision at one candidate size, or None when the column would
    decode whole anyway (covers both element- and group-chunkable graphs; the
    per-chunk weights carry the uneven group-span byte counts to the model)."""
    k, tail = p.decode_chunking(chunk_bytes)
    if k <= 1:
        return None
    return ColumnDecision(p.name, chunk_bytes, k, CHUNK, tail, t, d,
                          weights=p.chunk_weights(chunk_bytes))


def _decide_fixed(p: ColumnProfile, t: float, d: float,
                  chunk_bytes: int | None, chunk_decode: bool) -> ColumnDecision:
    """Legacy-shaped decision: one global chunk size, decode mode from the
    chunk_decode flag (per-chunk only where the graph supports it).  ``t``/``d``
    are the same per-column times the makespan simulator scores with."""
    if chunk_decode and chunk_bytes is not None:
        cand = _chunk_decision(p, t, d, chunk_bytes)
        if cand is not None:
            return cand
    return ColumnDecision(p.name, chunk_bytes,
                          p.n_transfer_chunks(chunk_bytes), WHOLE, 1.0, t, d)


def _decide_auto(p: ColumnProfile, t: float, d: float, overhead: float,
                 fixed_chunk_bytes: int | None,
                 cost_model: CostModel) -> ColumnDecision:
    """Per-column chunk size + decode mode minimizing the column's own modeled
    pipeline time (ties break toward fewer launches).

    Candidates come from ``CostModel.chunk_ladder``: element-chunk sizes
    snapped to kernel tile multiples (core/geometry.py), group-chunk sizes
    snapped to group-boundary prefix sums, both tuned by the calibrated cost
    model; the legacy fixed ladder only backstops profiles without geometry."""
    job = scheduler.Job(p.name, t, d)
    whole_cb = fixed_chunk_bytes or DEFAULT_CHUNK_BYTES
    best = ColumnDecision(p.name, whole_cb, p.n_transfer_chunks(whole_cb),
                          WHOLE, 1.0, t, d)
    best_mk = scheduler.simulate_stream([job], [_chunk_info(best, overhead)])
    cands = set(cost_model.chunk_ladder(p))
    if not cands:
        cands = set(CHUNK_CANDIDATES)
        if p.chunkable and p.per_elem_bytes > 0 and p.n_out > 0:
            tile_bytes = p.per_elem_bytes * p.n_out
            cands |= {max(MIN_CHUNK_BYTES, int(tile_bytes / k))
                      for k in (2, 4, 8)}
    cands.add(whole_cb)
    for cb in sorted(cands, reverse=True):
        cand = _chunk_decision(p, t, d, cb)
        if cand is None:
            continue
        mk = scheduler.simulate_stream([job], [_chunk_info(cand, overhead)])
        if mk < best_mk - 1e-12:
            best, best_mk = cand, mk
    return best


def _mark_batched(decisions: dict[str, ColumnDecision],
                  profiles: Mapping[str, ColumnProfile]) -> None:
    """Whole-mode columns sharing a structural signature decode in one batched
    launch per stage; mark them so the executor groups them."""
    by_sig: dict[str, list[str]] = {}
    for name, d in decisions.items():
        if d.decode_mode == WHOLE and not d.fused:
            by_sig.setdefault(profiles[name].signature, []).append(name)
    for names in by_sig.values():
        if len(names) > 1:
            for n in names:
                decisions[n] = dataclasses.replace(decisions[n],
                                                   decode_mode=BATCHED)


def _window_for(decisions: Mapping[str, ColumnDecision],
                jobs: Sequence[scheduler.Job] | None = None,
                infos: Sequence[ChunkInfo] | None = None,
                order: Sequence[int] | None = None) -> int:
    """In-flight staging window (transferred-but-undecoded chunks held at once).

    Cost-driven: the smallest window whose simulated makespan matches the
    unbounded pipeline -- the staging buffer stops paying for itself beyond
    that.  Columns with no per-chunk decode get classic double buffering."""
    ks = [d.n_chunks for d in decisions.values() if d.decode_mode == CHUNK]
    if not ks:
        return 2
    if jobs is None:
        return min(8, max(2, max(ks) // 8 + 2))
    base = scheduler.simulate_stream(jobs, infos, order)
    for w in (2, 3, 4, 6, 8):
        if scheduler.simulate_stream(jobs, infos, order,
                                     window=w) <= base * (1 + 1e-9):
            return w
    return 8


def plan_execution(profiles: Mapping[str, ColumnProfile] | Sequence[ColumnProfile],
                   cost_model: CostModel,
                   policy: str | SchedulingPolicy = "adaptive",
                   chunk_bytes: int | None | str = "auto",
                   chunk_decode: bool = False,
                   window: int | None = None,
                   batch_columns: bool = True,
                   fused_columns: Mapping[str, float | None] | None = None
                   ) -> ExecutionPlan:
    """Choose, per column, chunk size / decode mode / issue order / window.

    ``chunk_bytes`` may be an int (global fixed size), None (whole-blob
    transfer) or "auto" (per-column sizing).  ``policy="adaptive"`` searches
    chunk configurations x issue orders and keeps the modeled-makespan minimum;
    fixed policies order the configuration implied by ``chunk_bytes``/
    ``chunk_decode`` directly (the executor's legacy behaviour, now explicit).

    ``fused_columns`` maps columns a pending query could decode-fuse to a
    selectivity estimate (None = the cost model's learned per-signature EWMA).
    Fusion is decided per column AFTER the order search: fuse iff the
    selectivity-scaled fused decode beats decode + the query's re-read of the
    materialized column, then the makespan is re-simulated with the fused
    decode times so the reported number stays honest.  Baselines are computed
    before the adjustment (they model materialize-then-query).
    """
    if not isinstance(profiles, Mapping):
        profiles = {p.name: p for p in profiles}
    names = list(profiles)
    for p in profiles.values():
        if p.name not in cost_model.profiles:
            cost_model.register(p)
    pol = get_policy(policy)
    jobs = cost_model.jobs(names)
    # decisions are priced with the SAME per-column times the simulator scores
    # with (predict() can disagree with jobs() before calibration)
    times = {j.name: (j.transfer_s, j.decompress_s) for j in jobs}
    overheads = [cost_model.launch_overhead_s(n) for n in names]

    fixed_cb = chunk_bytes if isinstance(chunk_bytes, int) else \
        (None if chunk_bytes is None else DEFAULT_CHUNK_BYTES)
    auto = chunk_bytes == "auto"
    executed_kind = "auto" if auto else \
        ("fixed-chunk" if chunk_decode else "whole")

    def decisions_of(kind: str) -> dict[str, ColumnDecision]:
        # "fixed-chunk" honours chunk_bytes=None (whole-blob transfer stays
        # whole-blob even with chunk_decode=True -- _decide_fixed degrades to
        # whole mode)
        if kind == "auto":
            return {n: _decide_auto(profiles[n], *times[n],
                                    cost_model.launch_overhead_s(n), fixed_cb,
                                    cost_model)
                    for n in names}
        return {n: _decide_fixed(profiles[n], *times[n], fixed_cb,
                                 kind == "fixed-chunk") for n in names}

    def infos_of(decisions: dict[str, ColumnDecision]) -> list[ChunkInfo]:
        return [_chunk_info(decisions[n], o) for n, o in zip(names, overheads)]

    if len(names) <= 1:
        # trivial plan: one (or zero) columns has exactly one order and no
        # meaningful baselines -- skip the search (the per-request serve path)
        decisions = decisions_of(executed_kind)
        order = list(range(len(names)))
        makespan_s = scheduler.simulate_stream(jobs, infos_of(decisions), order)
        baselines: dict[str, float] = {}
    else:
        # shared-model baselines (whole-column FIFO/Johnson, fixed-chunk
        # Johnson).  Every baseline is a configuration the search below may
        # also pick, so the adaptive plan's makespan is <= min(baselines) by
        # construction -- in particular the chunk-johnson baseline honours
        # chunk_bytes=None (where it degrades to whole-column decode) rather
        # than substituting a chunk size the caller forbade.
        whole_dec = decisions_of("whole")
        whole_infos = infos_of(whole_dec)
        fixedc_dec = decisions_of("fixed-chunk")
        baselines = {
            "fifo": scheduler.simulate_stream(
                jobs, whole_infos, scheduler.fifo_order(jobs)),
            "johnson": scheduler.simulate_stream(
                jobs, whole_infos, scheduler.johnson_order(jobs)),
            "chunk-johnson": scheduler.ChunkJohnsonPolicy().modeled_makespan(
                jobs, infos_of(fixedc_dec)),
        }
        if pol.name == "adaptive":
            # global search: chunk configurations x candidate orders; includes
            # the baseline configs, so the makespan is <= min(baselines)
            search = [decisions_of("auto")] if auto else []
            search += [whole_dec, fixedc_dec]
            best_dec, best_order, best_mk = None, None, float("inf")
            for dec in search:
                infos = infos_of(dec)
                order = pol.order(jobs, infos)
                mk = scheduler.simulate_stream(jobs, infos, order)
                if mk < best_mk - 1e-15:
                    best_dec, best_order, best_mk = dec, order, mk
            decisions, order, makespan_s = best_dec, best_order, best_mk
        else:
            decisions = decisions_of(executed_kind)
            infos = infos_of(decisions)
            order = pol.order(jobs, infos)
            makespan_s = scheduler.simulate_stream(jobs, infos, order)

    if fused_columns:
        # fused-vs-materialize is a per-column comparison, independent of the
        # issue order, so it composes with (and runs after) the order search
        idx = {n: i for i, n in enumerate(names)}
        jobs = list(jobs)
        for n, sel in fused_columns.items():
            if n not in decisions:
                continue
            s = cost_model.selectivity_for(n) if sel is None else float(sel)
            fd = cost_model.fused_decode_s(n, s)
            t, d = times[n]
            if fd < d + cost_model.query_read_s(n) - 1e-15:
                decisions[n] = dataclasses.replace(
                    decisions[n], fused=True, selectivity=s, est_decode_s=fd)
                jobs[idx[n]] = scheduler.Job(n, t, fd)
        makespan_s = scheduler.simulate_stream(jobs, infos_of(decisions), order)

    if batch_columns:
        _mark_batched(decisions, profiles)
    return ExecutionPlan(
        order=tuple(names[i] for i in order), decisions=dict(decisions),
        policy=pol.name, window=window if window is not None
        else _window_for(decisions, jobs, infos_of(decisions), order),
        modeled_makespan_s=makespan_s, baselines=baselines)
