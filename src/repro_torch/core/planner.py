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

``plan_mesh_execution`` plans a decode over a mesh of N devices: which
device's link each column (or group-span shard of a large column) streams
over and decodes on, scored by ``scheduler.simulate_stream_multi``; its
``MeshExecutionPlan`` is plain data and needs no devices;
``StreamingExecutor.run_sharded`` executes one.

Under ``torch.profiler`` ``plan_execution`` shows its steps as spans
(``core/trace.py``): ``repro_torch.plan.decide`` (a configuration's per-column
decisions), ``plan.order`` (an issue order and its scoring) and ``plan.window``.

This is the reference's ``core/planner.py``; ``tests/test_torch_planner.py``
and ``tests/test_torch_mesh_plan.py`` hold its plans equal to the reference's
on the same profiles and cost model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core import costmodel as costmodel_mod, scheduler
from repro_torch.core.costmodel import ColumnProfile, CostModel, LinkTopology
from repro_torch.core.scheduler import ChunkInfo, SchedulingPolicy, get_policy
from repro_torch.core.trace import span

DEFAULT_CHUNK_BYTES = 1 << 20
# legacy fixed ladder (64 KiB .. 4 MiB), kept only as the fallback when a
# column's geometry-tied ladder is empty (e.g. profiles with no tile info);
# ``CostModel.chunk_ladder`` supplies the real candidates: element chunks
# snapped to kernel tile multiples, group chunks snapped to group-boundary
# prefix sums, both pruned by the calibrated launch-overhead estimate
CHUNK_CANDIDATES = (1 << 16, 1 << 18, 1 << 20, 1 << 22)
MIN_CHUNK_BYTES = 1 << 12
# ``StreamingExecutor.plan`` hands back its last plan while the search's
# priced inputs stay within this relative distance of its snapshot (each
# column's predicted transfer + decode time, L1 over their sum; and
# ``CostModel.decode_scale``): above the call-to-call drift of warm loads on
# an H100, below what one large column's time doubling moves
REPLAN_DRIFT = 0.15

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
    with span("plan.window"):
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
        with span("plan.decide"):
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
        with span("plan.order"):
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
                with span("plan.order"):
                    order = pol.order(jobs, infos)
                    mk = scheduler.simulate_stream(jobs, infos, order)
                if mk < best_mk - 1e-15:
                    best_dec, best_order, best_mk = dec, order, mk
            decisions, order, makespan_s = best_dec, best_order, best_mk
        else:
            decisions = decisions_of(executed_kind)
            infos = infos_of(decisions)
            with span("plan.order"):
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


# ------------------------------------------------------------ mesh planning

SHARD_SEP = "::shard"


def shard_name(column: str, index: int) -> str:
    return f"{column}{SHARD_SEP}{index}"


def shard_column_of(item: str) -> str:
    """Parent column of a shard item name (identity for whole columns)."""
    return item.rsplit(SHARD_SEP, 1)[0] if SHARD_SEP in item else item


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """One contiguous group-span shard of a column, bound for one device."""

    column: str
    index: int
    g_lo: int                     # first group (inclusive, GLOBAL group id)
    g_hi: int                     # past-last group
    out_lo: int                   # output element range [out_lo, out_hi)
    out_hi: int

    @property
    def name(self) -> str:
        return shard_name(self.column, self.index)

    @property
    def n_groups(self) -> int:
        return self.g_hi - self.g_lo

    @property
    def n_out(self) -> int:
        return self.out_hi - self.out_lo


@dataclasses.dataclass(frozen=True)
class MeshExecutionPlan:
    """Topology-aware plan over a device mesh: per-device ``ExecutionPlan``s
    plus the item->device assignment and the group-span shards of any column
    too large for one device.  The modeled makespan comes from
    ``scheduler.simulate_stream_multi`` (N links, shared host staging budget)
    and -- mirroring the single-device planner's dominance contract -- is
    <= the naive round-robin AND single-device baselines by construction:
    both are candidates the assignment search scores.

    Two-tier topologies split LANDING from PLACEMENT: ``assignment`` is
    where each item's bytes stream and decode (minimizing H2D makespan over
    the measured per-link scales), ``placement`` is where its decoded output
    must finally reside (the consumer's desired sharding), and
    ``redistribution`` lists the ``(item, src, dst)`` device->device copy
    legs that bridge the two over the D2D fabric.  Without a fabric (or
    without a placement constraint) the three coincide and the plan is
    exactly the single-tier one."""

    n_devices: int
    device_ids: tuple[int, ...]           # logical link -> physical device index
    plans: tuple[ExecutionPlan, ...]      # one per logical device
    assignment: Mapping[str, int]         # item name -> LANDING logical device
    shards: Mapping[str, tuple[ShardSpec, ...]]   # column -> its shards
    policy: str                           # winning assignment candidate
    window: int
    modeled_makespan_s: float
    baselines: Mapping[str, float] = dataclasses.field(default_factory=dict)
    topology: LinkTopology = dataclasses.field(default_factory=LinkTopology)
    # item name -> FINAL logical device (== assignment unless redistributed)
    placement: Mapping[str, int] = dataclasses.field(default_factory=dict)
    # (item, src logical, dst logical) D2D copy legs, in plan item order
    redistribution: tuple[tuple[str, int, int], ...] = ()
    # the placement constraint the plan was built under (None = unconstrained);
    # elastic re-planning re-applies it to the suffix
    placement_policy: str | None = None

    def final_device(self, item: str) -> int:
        """FINAL logical device of ``item`` (landing device when no
        redistribution moves it)."""
        return int(self.placement.get(item, self.assignment.get(item, 0)))

    @property
    def items(self) -> tuple[str, ...]:
        return tuple(self.assignment)

    def columns(self) -> tuple[str, ...]:
        """Distinct parent columns covered by the plan."""
        seen: list[str] = []
        for item in self.assignment:
            col = shard_column_of(item)
            if col not in seen:
                seen.append(col)
        return tuple(seen)

    def explain(self) -> str:
        lines = [f"mesh plan: devices={self.n_devices} policy={self.policy} "
                 f"window={self.window} "
                 f"modeled_makespan={self.modeled_makespan_s * 1e3:.3f}ms"]
        for ref, mk in sorted(self.baselines.items()):
            lines.append(f"  baseline {ref:14s} {mk * 1e3:.3f}ms")
        for item, src, dst in self.redistribution:
            lines.append(f"  redistribute {item}: device {src} -> {dst} "
                         f"(d2d_scale={self.topology.d2d_scale})")
        for d, plan in enumerate(self.plans):
            dev = self.device_ids[d] if d < len(self.device_ids) else d
            lines.append(f"  device {d} (cuda device {dev}): "
                         f"{len(plan.order)} items, "
                         f"local makespan {plan.modeled_makespan_s * 1e3:.3f}ms")
            for item in plan.order:
                dd = plan.decisions[item]
                lines.append(f"    {item:28s} mode={dd.decode_mode:8s} "
                             f"n_chunks={dd.n_chunks:3d} "
                             f"pred=({dd.est_transfer_s * 1e3:.3f}ms,"
                             f"{dd.est_decode_s * 1e3:.3f}ms)")
        return "\n".join(lines)


def _shard_bounds(p: ColumnProfile, n_shards: int) -> list[int]:
    """Contiguous group boundaries splitting ``p`` into ``n_shards`` spans of
    near-equal decoded output, snapped to group-boundary prefix sums."""
    ps = np.asarray(p.group_out_presum, dtype=np.int64)
    total = int(ps[-1])
    bounds = [0]
    for k in range(1, n_shards):
        g = int(np.searchsorted(ps, round(total * k / n_shards), side="left"))
        g = min(max(g, bounds[-1] + 1), p.n_groups - (n_shards - k))
        bounds.append(g)
    bounds.append(p.n_groups)
    return bounds


def _shard_decision(p: ColumnProfile, parent: ColumnDecision, spec: ShardSpec,
                    t_col: float, d_col: float) -> ColumnDecision:
    """Plan one shard the way the executor's range schedule will run it:
    spans of ``groups_per_chunk`` whole groups inside [g_lo, g_hi), the
    whole-resident prologue bytes replicated ahead of each shard's span 0."""
    whole_bytes = max(0.0, p.compressed_nbytes - p.group_bytes * p.n_groups)
    span_bytes = spec.n_groups * p.group_bytes
    t = t_col * (whole_bytes + span_bytes) / max(p.compressed_nbytes, 1)
    d = d_col * spec.n_out / max(p.n_out if p.chunkable else
                                 int(np.asarray(p.group_out_presum)[-1]), 1)
    cb = parent.chunk_bytes
    k, tail, weights = 1, 1.0, ()
    if cb is not None and p.group_bytes > 0:
        G = costmodel_mod.groups_per_chunk(cb, p.group_bytes, p.group_align)
        k = math.ceil(spec.n_groups / G)
        if k > 1:
            ps = np.asarray(p.group_out_presum, dtype=np.float64)
            bnds = list(range(spec.g_lo, spec.g_hi, G)) + [spec.g_hi]
            out_sizes = np.diff(ps[bnds])
            g_sizes = np.diff(bnds).astype(np.float64)
            transfer = g_sizes * p.group_bytes
            transfer[0] += whole_bytes
            t_tot = float(transfer.sum()) or 1.0
            d_tot = float(out_sizes.sum()) or 1.0
            weights = tuple((float(a) / t_tot, float(b) / d_tot)
                            for a, b in zip(transfer, out_sizes))
            body = float(np.mean(out_sizes[:-1]))
            tail = float(min(1.0, max(out_sizes[-1] / max(body, 1e-9), 1e-3)))
    return ColumnDecision(spec.name, cb, k, CHUNK if k > 1 else WHOLE,
                          tail, t, d, weights=weights)


def plan_mesh_execution(
        profiles: Mapping[str, ColumnProfile] | Sequence[ColumnProfile],
        cost_model: CostModel,
        n_devices: int,
        policy: str | SchedulingPolicy = "adaptive",
        chunk_bytes: int | None | str = "auto",
        chunk_decode: bool = True,
        window: int | None = None,
        batch_columns: bool = True,
        shard_threshold_bytes: int | None = None,
        device_ids: Sequence[int] | None = None,
        topology: LinkTopology | None = None,
        placement: str | None = None) -> MeshExecutionPlan:
    """Assign columns (and group-span shards of oversized columns) to the
    devices of a mesh, minimizing the ``simulate_stream_multi`` makespan.

    Per-column chunking / decode-mode decisions come from the single-device
    planner (``plan_execution``) -- the mesh layer only decides WHERE each
    item streams and decodes.  Columns whose compressed bytes exceed
    ``shard_threshold_bytes`` (default: the per-device fair share of the
    total) and whose graphs are group-chunkable split into ``n_devices``
    contiguous group-span shards balanced by decoded output; each shard
    decodes shard-local on its device with GLOBAL group/output offsets, so
    outputs land already laid out for a sharded consumer.

    The assignment search is greedy LPT (longest processing time first onto
    the least-loaded device) followed by local exchange; the naive
    round-robin and single-device assignments are ALWAYS scored too, so the
    chosen makespan is <= both baselines by construction -- the same
    dominance contract ``plan_execution`` gives over FIFO/Johnson.

    ``placement="sharded"`` constrains shard ``i`` of every sharded column
    to FINALLY reside on logical device ``i`` (the canonical layout
    a sharded consumer reads).  When the topology
    carries a D2D fabric (``topo.d2d_scale``), the search then decouples
    landing from placement: free-landing candidates stream each shard over
    the cheapest host link, decode it where it landed, and pay a modeled
    fabric copy (priced by ``LinkTopology.d2d_copy_s`` on the shard's
    DECODED bytes) to reach its required device -- with the pinned
    decode-in-place assignment ("no-redistribution") always among the
    scored candidates, so the chosen makespan never exceeds today's plan.
    Without a fabric the shard items are simply pinned in place and no
    redistribution is emitted.
    """
    if not isinstance(profiles, Mapping):
        profiles = {p.name: p for p in profiles}
    N = max(1, int(n_devices))
    topo = (topology if topology is not None
            else cost_model.topology.resized(N))
    base = plan_execution(profiles, cost_model, policy=policy,
                          chunk_bytes=chunk_bytes, chunk_decode=chunk_decode,
                          window=window, batch_columns=False)
    names = list(base.order)
    overheads = {n: cost_model.launch_overhead_s(n) for n in names}

    # ------------------------------------------------- item sets (whole/shard)
    total_bytes = sum(profiles[n].compressed_nbytes for n in names)
    threshold = (shard_threshold_bytes if shard_threshold_bytes is not None
                 else max(1, total_bytes // N))
    shards: dict[str, tuple[ShardSpec, ...]] = {}
    if N > 1:
        for n in names:
            p = profiles[n]
            if (p.group_chunkable and p.group_out_presum is not None
                    and p.n_groups >= 2 * N
                    and p.compressed_nbytes > threshold):
                ps = np.asarray(p.group_out_presum, dtype=np.int64)
                bounds = _shard_bounds(p, N)
                shards[n] = tuple(
                    ShardSpec(column=n, index=i, g_lo=lo, g_hi=hi,
                              out_lo=int(ps[lo]), out_hi=int(ps[hi]))
                    for i, (lo, hi) in enumerate(zip(bounds, bounds[1:])))

    def build_items(use_shards: bool):
        """-> (item names, jobs, infos, decisions) in base order, shards
        replacing their parent column in place."""
        items, jobs, infos, decs = [], [], [], {}
        for n in names:
            d = base.decisions[n]
            if use_shards and n in shards:
                for spec in shards[n]:
                    sd = _shard_decision(profiles[n], d, spec,
                                         d.est_transfer_s, d.est_decode_s)
                    items.append(spec.name)
                    jobs.append(scheduler.Job(spec.name, sd.est_transfer_s,
                                              sd.est_decode_s))
                    infos.append(_chunk_info(sd, overheads[n]))
                    decs[spec.name] = sd
            else:
                items.append(n)
                jobs.append(scheduler.Job(n, d.est_transfer_s,
                                          d.est_decode_s))
                infos.append(_chunk_info(d, overheads[n]))
                decs[n] = d
        return items, jobs, infos, decs

    whole_set = build_items(False)
    item_sets = {"whole": whole_set}
    if shards:
        item_sets["sharded"] = build_items(True)

    # ------------------------------------------------ placement / redistribution
    # placement="sharded": shard i of every sharded column must FINALLY sit on
    # logical device i.  required maps sharded-set job index -> that device;
    # d2d_equiv prices the shard's DECODED bytes as host-link-equivalent
    # seconds (the unit LinkTopology.d2d_copy_s converts to fabric time).
    place_shards = placement == "sharded" and "sharded" in item_sets
    required: dict[int, int] = {}
    d2d_equiv: dict[int, float] = {}
    if place_shards:
        s_items = item_sets["sharded"][0]
        specs_by_name = {s.name: s for ss in shards.values() for s in ss}
        for i, it in enumerate(s_items):
            spec = specs_by_name.get(it)
            if spec is None:
                continue
            required[i] = spec.index % N
            p = profiles[spec.column]
            total_out = int(np.asarray(p.group_out_presum)[-1]) or 1
            dec_bytes = p.plain_nbytes * spec.n_out / total_out
            d2d_equiv[i] = (base.decisions[spec.column].est_transfer_s
                            * dec_bytes / max(p.compressed_nbytes, 1))

    def copies_for(key: str, assign: list[int]) -> list[tuple[int, float]]:
        """D2D copy jobs an assignment implies: one fabric copy per shard
        whose landing device differs from its required placement."""
        if not (place_shards and key == "sharded" and topo.has_fabric):
            return []
        return [(i, topo.d2d_copy_s(d2d_equiv[i]))
                for i, r in required.items() if assign[i] != r]

    def score(key: str, assign: list[int], serial_issue: bool = False
              ) -> float:
        _, jobs, infos, _ = item_sets[key]
        mk, _ = scheduler.simulate_stream_multi(
            jobs, infos, assign, n_links=N, window=base.window,
            link_scale=topo.link_scale, link_latency_s=topo.link_latency_s,
            host_window=topo.host_window, serial_issue=serial_issue,
            d2d_copies=copies_for(key, assign))
        return mk

    def lpt(key: str, pinned: Mapping[int, int] | None = None) -> list[int]:
        """Greedy longest-processing-time-first onto the least-loaded link
        (loads in link-scaled time so slow links get less work); ``pinned``
        items are pre-placed and only contribute load."""
        _, jobs, _, _ = item_sets[key]
        load = [0.0] * N
        assign = [0] * len(jobs)
        for i, d in (pinned or {}).items():
            assign[i] = d
            load[d] += jobs[i].transfer_s * topo.scale(d) + jobs[i].decompress_s
        order = sorted((i for i in range(len(jobs))
                        if not pinned or i not in pinned),
                       key=lambda i: -(jobs[i].transfer_s
                                       + jobs[i].decompress_s))
        for i in order:
            d = min(range(N), key=lambda x: (load[x], x))
            assign[i] = d
            load[d] += jobs[i].transfer_s * topo.scale(d) + jobs[i].decompress_s
        return assign

    def exchange(key: str, assign: list[int],
                 frozen: Mapping[int, int] | None = None) -> list[int]:
        """Local move/swap refinement: accept any single-item move or pairwise
        swap that lowers the simulated makespan; bounded passes.  ``frozen``
        items never move (pinned decode-in-place shards)."""
        best = list(assign)
        best_mk = score(key, best)
        n_items = len(best)
        fro = frozen or {}
        for _ in range(3):                       # passes; usually converges in 1
            improved = False
            for i in range(n_items):
                if i in fro:
                    continue
                for d in range(N):
                    if d == best[i]:
                        continue
                    cand = list(best)
                    cand[i] = d
                    mk = score(key, cand)
                    if mk < best_mk - 1e-15:
                        best, best_mk, improved = cand, mk, True
            for i in range(n_items):
                if i in fro:
                    continue
                for j in range(i + 1, n_items):
                    if j in fro or best[i] == best[j]:
                        continue
                    cand = list(best)
                    cand[i], cand[j] = cand[j], cand[i]
                    mk = score(key, cand)
                    if mk < best_mk - 1e-15:
                        best, best_mk, improved = cand, mk, True
            if not improved:
                break
        return best

    # --------------------------------------------------- candidate assignments
    candidates: dict[str, tuple[str, list[int]]] = {}   # label -> (set key, assign)
    n_whole = len(whole_set[0])
    candidates["round-robin"] = ("whole", [i % N for i in range(n_whole)])
    candidates["single-device"] = ("whole", [0] * n_whole)
    for key in item_sets:
        if place_shards and key == "sharded":
            # decode-in-place baseline: shards pinned to their required
            # device (exactly today's plan) -- ALWAYS scored, so a
            # redistribute candidate wins only when its modeled makespan,
            # fabric copies included, beats it
            a = lpt(key, pinned=required)
            candidates["no-redistribution"] = (key, a)
            candidates["no-redistribution+exchange"] = (
                key, exchange(key, a, frozen=required))
            if topo.has_fabric:
                f = lpt(key)
                candidates[f"lpt-{key}+redistribute"] = (key, f)
                candidates[f"lpt-{key}+redistribute+exchange"] = (
                    key, exchange(key, f))
        else:
            a = lpt(key)
            candidates[f"lpt-{key}"] = (key, a)
            candidates[f"lpt-{key}+exchange"] = (key, exchange(key, a))

    scored = {label: score(key, a)
              for label, (key, a) in candidates.items()}
    chosen = min(scored, key=lambda lbl: (scored[lbl], lbl))
    set_key, assign = candidates[chosen]
    # price the serialized host loop on the CHOSEN assignment: the
    # overlapped-issue makespan vs. what the same plan costs when one host
    # thread walks the devices one after another -- recorded as a baseline
    scored["serial-issue"] = score(set_key, assign, serial_issue=True)
    items, jobs, infos, decisions = item_sets[set_key]
    chosen_shards = shards if set_key == "sharded" else {}
    copies = copies_for(set_key, assign)
    redistribution = tuple((items[i], int(assign[i]), int(required[i]))
                           for i, _ in copies)

    # ------------------------------------------------------- per-device plans
    assignment = dict(zip(items, assign))
    plans = []
    for d in range(N):
        d_items = [it for it in items if assignment[it] == d]
        d_dec = {it: decisions[it] for it in d_items}
        if batch_columns:
            # same-signature whole columns CO-LOCATED on one device still
            # batch into one batched launch per stage; shard items have no profile
            # and stay unbatched
            d_profiles = {it: profiles[it] for it in d_items if it in profiles}
            batch_view = {it: d_dec[it] for it in d_profiles}
            _mark_batched(batch_view, d_profiles)
            d_dec.update(batch_view)
        d_jobs = [jobs[items.index(it)] for it in d_items]
        d_infos = [infos[items.index(it)] for it in d_items]
        local_mk = scheduler.simulate_stream(
            d_jobs, d_infos, window=base.window) if d_items else 0.0
        plans.append(ExecutionPlan(
            order=tuple(d_items), decisions=d_dec,
            policy=f"mesh:{chosen}", window=base.window,
            modeled_makespan_s=local_mk))
    dev_ids = (tuple(int(x) for x in device_ids) if device_ids is not None
               else tuple(range(N)))
    placement_map = dict(assignment)
    for it, _src, dst in redistribution:
        placement_map[it] = dst
    return MeshExecutionPlan(
        n_devices=N, device_ids=dev_ids, plans=tuple(plans),
        assignment=assignment, shards=chosen_shards, policy=chosen,
        window=base.window, modeled_makespan_s=scored[chosen],
        baselines=dict(scored), topology=topo,
        placement=placement_map, redistribution=redistribution,
        placement_policy=placement)
