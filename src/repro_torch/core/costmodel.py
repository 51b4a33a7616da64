"""Cost model for transfer/decode planning (the paper's §3.3), and the chunk
formulas the executor and the planner share.

``CostModel`` predicts each column's ``(transfer_s, decode_s)`` from a chip
model -- transfer = compressed bytes / host-link rate, decode = (compressed +
plain) device-memory traffic / bandwidth plus a per-launch overhead, from
``geometry.ChipSpec`` -- and calibrates it against the executor's measured
actuals: every ``observe`` updates a transfer and a decode scale (measured /
raw model) by an EWMA, so estimates for columns never run are in the same
units as measurements.  ``ColumnProfile`` is the planner's static summary of a
column (leaf sizes, chunkability, tile geometry), enough to predict how many
transfer pieces and decode chunks any ``chunk_bytes`` gives, with the same
formulas the executor slices with, so planned counts equal executed ones.

This is the reference's ``core/costmodel.py``, arithmetic for arithmetic; the
chip model is the card's (``geometry.CHIPS["h100"]``).  The reference's
``serial_host`` (a JAX backend query) has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core import scheduler
from repro_torch.core.geometry import DEFAULT_CHIP, chip as chip_spec, native_subtile

# output-pad granularity for uneven group spans: body spans pad to one shared
# shape, so one span program serves every body span of a structure
GROUP_PAD_ELEMS = 128

# prior for query predicate selectivity before any fused run has been observed
DEFAULT_SELECTIVITY = 0.5


def rows_per_chunk(shape0: int, nbytes: int, chunk_bytes: int) -> int:
    """Rows of an axis-0-split buffer that fit in one transfer chunk."""
    return max(1, chunk_bytes // max(1, nbytes // max(1, shape0)))


def aligned_chunk_elems(chunk_bytes: int, per_elem_bytes: float, align: int) -> int:
    """Output elements per decode chunk: about ``chunk_bytes`` of compressed
    tile bytes, rounded down to the boundary alignment (at least one)."""
    elems = int(chunk_bytes / max(per_elem_bytes, 1e-9)) // align * align
    return max(align, elems)


def groups_per_chunk(chunk_bytes: int, bytes_per_group: float, align: int) -> int:
    """Whole groups per decode span: about ``chunk_bytes`` of streamed group
    bytes, rounded down to the group-boundary alignment (at least one)."""
    g = int(chunk_bytes / max(bytes_per_group, 1e-9)) // align * align
    return max(align, g)


def pad_group_elems(elems: int) -> int:
    return max(GROUP_PAD_ELEMS, -(-int(elems) // GROUP_PAD_ELEMS) * GROUP_PAD_ELEMS)


def group_bytes_per_group(layout, ops: Mapping[str, np.ndarray]) -> float:
    """Streamed (sliced-leaf) compressed bytes per group of a
    ``GroupChunkLayout``: axis-0 leaves give ``num/den`` rows per group, axis-1
    leaves (the rANS stripe) one column per group."""
    total = 0.0
    for nm, spec in layout.sliced.items():
        arr = np.asarray(ops[nm])
        if layout.axes.get(nm, 0) == 1:
            total += float(arr.shape[0]) * arr.dtype.itemsize
        else:
            num = int(np.asarray(ops[spec.num_op])[0]) if spec.num_op else spec.num
            row = arr.dtype.itemsize * (int(np.prod(arr.shape[1:])) if arr.ndim > 1 else 1)
            total += num / spec.den * row
    return total


@dataclasses.dataclass(frozen=True)
class LinkTopology:
    """Host->device interconnect description for mesh planning.

    One entry per device-facing link: ``link_scale[d]`` multiplies the
    calibrated single-link transfer time on link ``d`` (1.0 = the host link
    the EWMA loop was calibrated against; >1 = a slower link, e.g. a PCIe
    switch shared leg), ``link_latency_s[d]`` is a fixed per-piece issue
    latency, and ``host_window`` bounds the TOTAL number of transferred-but-
    undecoded chunks staged across all links (the shared pinned-host-buffer
    budget ``scheduler.simulate_stream_multi`` models).  Missing entries
    default to (1.0, 0.0): a symmetric topology needs no explicit tables.

    The second tier is the device-to-device fabric (NVLink-class):
    ``d2d_scale`` multiplies the calibrated host-link transfer time for a
    device->device copy of the same byte count (an NVLink 5-10x faster than
    PCIe is ~0.1-0.2), ``d2d_latency_s`` adds a fixed per-copy issue latency.
    ``d2d_scale=None`` means NO fabric is modeled: the planner never proposes
    redistribution and the mesh simulator reduces exactly to the
    single-tier model.
    """

    n_links: int = 1
    link_scale: tuple[float, ...] = ()
    link_latency_s: tuple[float, ...] = ()
    host_window: int | None = None
    d2d_scale: float | None = None
    d2d_latency_s: float = 0.0

    def scale(self, d: int) -> float:
        return float(self.link_scale[d]) if d < len(self.link_scale) else 1.0

    def latency_s(self, d: int) -> float:
        return (float(self.link_latency_s[d])
                if d < len(self.link_latency_s) else 0.0)

    @property
    def has_fabric(self) -> bool:
        return self.d2d_scale is not None

    def d2d_copy_s(self, h2d_equiv_s: float) -> float:
        """Modeled device->device copy time for bytes whose host-link
        transfer would take ``h2d_equiv_s`` (the fabric is priced relative
        to the calibrated host link).  Infinite when no fabric exists, so a
        fabric-less topology can never make redistribution look cheap."""
        if self.d2d_scale is None:
            return float("inf")
        return max(0.0, float(h2d_equiv_s)) * float(self.d2d_scale) \
            + float(self.d2d_latency_s)

    def resized(self, n_links: int) -> "LinkTopology":
        """Same per-link (and fabric) parameters over a different link count
        (elastic re-planning keeps surviving links' characteristics)."""
        return dataclasses.replace(self, n_links=max(1, int(n_links)))

    def to_json(self) -> dict:
        return {"n_links": int(self.n_links),
                "link_scale": [float(x) for x in self.link_scale],
                "link_latency_s": [float(x) for x in self.link_latency_s],
                "host_window": (None if self.host_window is None
                                else int(self.host_window)),
                "d2d_scale": (None if self.d2d_scale is None
                              else float(self.d2d_scale)),
                "d2d_latency_s": float(self.d2d_latency_s)}

    @classmethod
    def from_json(cls, data) -> "LinkTopology":
        """Tolerant parse: known keys only, defaults for anything missing --
        old caches (no topology block, no d2d tier) and future caches (extra
        keys) both load."""
        if not isinstance(data, dict):
            return cls()
        hw = data.get("host_window")
        d2d = data.get("d2d_scale")
        return cls(
            n_links=max(1, int(data.get("n_links", 1))),
            link_scale=tuple(float(x) for x in data.get("link_scale", ())),
            link_latency_s=tuple(float(x)
                                 for x in data.get("link_latency_s", ())),
            host_window=None if hw is None else int(hw),
            d2d_scale=None if d2d is None else float(d2d),
            d2d_latency_s=float(data.get("d2d_latency_s", 0.0)))


@dataclasses.dataclass(frozen=True)
class ColumnProfile:
    """Planner-facing static summary of one compressed column."""

    name: str
    compressed_nbytes: int
    plain_nbytes: int
    n_kernels: int
    signature: str = ""
    # (shape[0], nbytes) per leaf buffer -- what the transfer actually splits
    leaves: tuple[tuple[int, int], ...] = ()
    # element-chunkable decode (FullyParallel-only graph, see ir.ChunkLayout)
    chunkable: bool = False
    n_out: int = 0
    per_elem_bytes: float = 0.0   # compressed tile bytes per output element
    align: int = 1                # output-element chunk-boundary granularity
    # group-chunkable decode (ir.GroupChunkLayout: GP expansions, ANS chunk grids)
    group_chunkable: bool = False
    n_groups: int = 0
    group_bytes: float = 0.0      # streamed (sliced-leaf) bytes per group
    group_align: int = 1          # group-boundary alignment
    pattern: str = "fp"           # dominant stage pattern ("fp" | "gp" | "np")
    # per-group output offsets (len n_groups+1), planning data -- excluded from
    # equality so same-structure profiles with different run data still compare
    group_out_presum: np.ndarray | None = dataclasses.field(
        default=None, compare=False, repr=False)

    def n_transfer_chunks(self, chunk_bytes: int | None) -> int:
        """Transfer pieces ``split_chunks`` issues for this column's leaves.
        Whole-blob transfer (None) is modeled as ONE piece, matching the
        executor's ``_n_chunks`` accounting."""
        if chunk_bytes is None:
            return 1
        total = 0
        for shape0, nbytes in self.leaves:
            if nbytes <= chunk_bytes or shape0 <= 1:
                total += 1
                continue
            total += math.ceil(shape0 / rows_per_chunk(shape0, nbytes,
                                                       chunk_bytes))
        return max(1, total)

    def _group_spans(self, chunk_bytes: int) -> tuple[int, int] | None:
        """(groups_per_span, n_spans) for group-boundary chunking, or None when
        the column decodes whole -- mirrors ``StreamingExecutor._build_schedule``."""
        if (not self.group_chunkable or self.n_groups <= 1
                or self.group_bytes <= 0):
            return None
        G = groups_per_chunk(chunk_bytes, self.group_bytes, self.group_align)
        if G >= self.n_groups:
            return None
        return G, math.ceil(self.n_groups / G)

    def decode_chunking(self, chunk_bytes: int | None) -> tuple[int, float]:
        """(n_chunks, tail_frac) the per-chunk decode path produces, mirroring
        ``StreamingExecutor._build_schedule``; (1, 1.0) when the column decodes
        whole (not chunkable, chunking off, or one chunk covers the column)."""
        if chunk_bytes is None:
            return 1, 1.0
        if self.chunkable and self.n_out > 0 and self.per_elem_bytes > 0:
            chunk_elems = aligned_chunk_elems(chunk_bytes, self.per_elem_bytes,
                                              self.align)
            if chunk_elems >= self.n_out:
                return 1, 1.0
            k = math.ceil(self.n_out / chunk_elems)
            tail = self.n_out - (k - 1) * chunk_elems
            return k, tail / chunk_elems
        spans = self._group_spans(chunk_bytes)
        if spans is None:
            return 1, 1.0
        G, k = spans
        ps = self.group_out_presum
        if ps is None or k <= 1:
            return k, 1.0
        bounds = list(range(0, self.n_groups, G)) + [self.n_groups]
        sizes = np.diff(np.asarray(ps, dtype=np.float64)[bounds])
        body = float(np.mean(sizes[:-1])) if len(sizes) > 1 else float(sizes[0])
        tail = float(sizes[-1]) / max(body, 1e-9)
        return k, float(min(1.0, max(tail, 1e-3)))

    def chunk_weights(self, chunk_bytes: int | None
                      ) -> tuple[tuple[float, float], ...]:
        """Per-chunk (transfer, decode) weight pairs for ``simulate_stream``'s
        uneven-chunk model, or () for the uniform-body + tail default.

        Group spans are genuinely uneven: transfer follows the streamed bytes
        per span (whole-resident leaves all land ahead of span 0), decode
        follows each span's output elements from the group-boundary prefix
        sums.  Element chunks keep the closed-form uniform+tail model."""
        if chunk_bytes is None:
            return ()
        spans = self._group_spans(chunk_bytes)
        if spans is None or self.group_out_presum is None:
            return ()
        G, k = spans
        if k <= 1:
            return ()
        ps = np.asarray(self.group_out_presum, dtype=np.float64)
        bounds = list(range(0, self.n_groups, G)) + [self.n_groups]
        out_sizes = np.diff(ps[bounds])
        g_sizes = np.diff(bounds).astype(np.float64)
        whole_bytes = max(
            0.0, self.compressed_nbytes - self.group_bytes * self.n_groups)
        transfer = g_sizes * self.group_bytes
        transfer[0] += whole_bytes
        t_tot = float(transfer.sum()) or 1.0
        d_tot = float(out_sizes.sum()) or 1.0
        return tuple((float(t) / t_tot, float(d) / d_tot)
                     for t, d in zip(transfer, out_sizes))


def profile_from(name: str, enc, graph) -> ColumnProfile:
    """Build a ColumnProfile from an Encoded blob + its DecodeGraph."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.ir import element_chunk_layout, group_chunk_layout
    from repro_torch.core.patterns import GroupParallel, NonParallel

    flat = plan_mod.flat_buffers(enc)
    leaves = tuple((int(v.shape[0]) if v.ndim else 1, int(v.nbytes))
                   for v in flat.values())
    layout = element_chunk_layout(graph)
    per_elem, align = 0.0, 1
    glayout = None
    n_groups, g_bytes, g_align, presum = 0, 0.0, 1, None
    pattern = "fp"
    if layout is not None:
        ops = plan_mod.host_operands(enc)
        for nm, spec in layout.tiled.items():
            num = int(ops[spec.num_op][0]) if spec.num_op else int(spec.num)
            per_elem += num / spec.den * np.dtype(ops[nm].dtype).itemsize
        align = int(layout.align)
    else:
        glayout = group_chunk_layout(graph)
        if glayout is not None:
            ops = plan_mod.host_operands(enc)
            n_groups = int(glayout.n_groups)
            g_bytes = group_bytes_per_group(glayout, ops)
            g_align = int(glayout.align_groups)
            presum = np.asarray(glayout.group_presum, dtype=np.int64)
            pattern = glayout.kind
        else:
            for st in graph.stages:
                if isinstance(st, NonParallel):
                    pattern = "np"
                elif isinstance(st, GroupParallel) and pattern == "fp":
                    pattern = "gp"
    return ColumnProfile(
        name=name, compressed_nbytes=int(enc.compressed_nbytes),
        plain_nbytes=int(enc.plain_nbytes), n_kernels=int(graph.n_kernels),
        signature=graph.signature, leaves=leaves,
        chunkable=layout is not None, n_out=int(graph.n_out),
        per_elem_bytes=per_elem, align=align,
        group_chunkable=glayout is not None, n_groups=n_groups,
        group_bytes=g_bytes, group_align=g_align, pattern=pattern,
        group_out_presum=presum)


class CostModel:
    """Per-column / per-chunk (transfer_s, decode_s) predictor with an
    EWMA-calibrated measured-feedback loop.

    ``measured`` is the authoritative wall-clock store (the executor's
    ``timings`` dict aliases it); ``observe`` additionally folds each
    measurement into the transfer/decode calibration scales so chip-model
    estimates for unmeasured columns land in wall-clock units.
    """

    def __init__(self, chip: str = DEFAULT_CHIP, alpha: float = 0.4):
        self.spec = chip_spec(chip)
        self.alpha = float(alpha)
        self.transfer_scale = 1.0
        self.decode_scale = 1.0
        self.n_observed = 0
        # every read-modify-write feedback path (observe / observe_selectivity
        # / observe_link) runs under this lock: the dispatch engine makes them
        # reachable while transfer workers are live, and torn EWMA updates
        # would silently corrupt calibration
        self._lock = threading.RLock()
        # host->device interconnect description for mesh planning; the default
        # single symmetric link keeps every single-device path unchanged
        self.topology = LinkTopology()
        self.profiles: dict[str, ColumnProfile] = {}
        self.measured: dict[str, tuple[float, float]] = {}
        # per-SIGNATURE running means of measured (transfer_s, decode_s): the
        # persistent half of the feedback loop -- a fresh process planning the
        # same column structures starts from history (``save``/``load``)
        self.sig_stats: dict[str, dict[str, float]] = {}
        # per-SIGNATURE EWMA of observed query selectivity (fused runs report
        # selected_rows / n_rows from the Reduce count lane)
        self.selectivity: dict[str, float] = {}

    # -------------------------------------------------------------- registry
    def register(self, profile: ColumnProfile) -> None:
        self.profiles[profile.name] = profile

    def forget(self, name: str) -> None:
        self.profiles.pop(name, None)
        self.measured.pop(name, None)

    # ---------------------------------------------------------- predictions
    def raw_estimate(self, name: str) -> tuple[float, float]:
        """Uncalibrated chip-model (transfer_s, decode_s)."""
        p = self.profiles[name]
        transfer = p.compressed_nbytes / (self.spec.host_link_gbps * 1e9)
        traffic = p.compressed_nbytes + p.plain_nbytes
        decode = (traffic / (self.spec.hbm_gbps * 1e9)
                  + p.n_kernels * self.spec.grid_step_overhead_ns * 1e-9)
        return transfer, decode

    def predict(self, name: str) -> tuple[float, float]:
        """Best available (transfer_s, decode_s): measured this process when we
        have it, the signature's persisted running mean (same structure = same
        shapes, so the history is directly comparable wall-clock) otherwise,
        EWMA-calibrated chip model as the fallback."""
        if name in self.measured:
            return self.measured[name]
        p = self.profiles.get(name)
        if p is not None and p.signature in self.sig_stats:
            s = self.sig_stats[p.signature]
            return float(s["transfer_s"]), float(s["decode_s"])
        t, d = self.raw_estimate(name)
        return t * self.transfer_scale, d * self.decode_scale

    def selectivity_for(self, name: str) -> float:
        """Learned predicate selectivity for this column's signature, or the
        ``DEFAULT_SELECTIVITY`` prior when no fused run has reported one."""
        p = self.profiles.get(name)
        if p is not None and p.signature in self.selectivity:
            return self.selectivity[p.signature]
        return DEFAULT_SELECTIVITY

    def fused_decode_s(self, name: str, sel: float | None = None) -> float:
        """Decode-fused cost: the fused chunk program still reads every
        compressed byte, but the decoded column is consumed in registers
        instead of being written to (and re-read from) HBM -- only the rows
        the predicate keeps do downstream aggregate arithmetic, so the
        plain-side traffic scales with selectivity."""
        sel = self.selectivity_for(name) if sel is None else float(sel)
        sel = min(1.0, max(0.0, sel))
        p = self.profiles[name]
        _, d = self.predict(name)
        traffic = p.compressed_nbytes + p.plain_nbytes
        return d * (p.compressed_nbytes + sel * p.plain_nbytes) / max(traffic, 1)

    def query_read_s(self, name: str) -> float:
        """What materialize-then-query pays on top of decode: the query
        operator re-reads the full decoded column from HBM."""
        p = self.profiles[name]
        return p.plain_nbytes / (self.spec.hbm_gbps * 1e9) * self.decode_scale

    def launch_overhead_s(self, name: str) -> float:
        """Cost of one *extra* decode launch (per-chunk decode dispatches the
        column's kernels once per chunk instead of once)."""
        p = self.profiles[name]
        return (p.n_kernels * self.spec.grid_step_overhead_ns * 1e-9
                * self.decode_scale)

    # ------------------------------------------------------------- feedback
    def observe(self, name: str, transfer_s: float, decode_s: float) -> None:
        """Feed one measured run back: store it and recalibrate the scales.
        Atomic: concurrent observers cannot tear the incremental means or the
        EWMA read-modify-write."""
        with self._lock:
            self.measured[name] = (float(transfer_s), float(decode_s))
            if name not in self.profiles:
                return
            sig = self.profiles[name].signature
            if sig:
                s = self.sig_stats.setdefault(
                    sig, {"n": 0.0, "transfer_s": 0.0, "decode_s": 0.0})
                s["n"] += 1.0
                s["transfer_s"] += (transfer_s - s["transfer_s"]) / s["n"]
                s["decode_s"] += (decode_s - s["decode_s"]) / s["n"]
            raw_t, raw_d = self.raw_estimate(name)
            a = self.alpha if self.n_observed else 1.0   # first sample snaps
            if raw_t > 0 and transfer_s > 0:
                self.transfer_scale += a * (transfer_s / raw_t
                                            - self.transfer_scale)
            if raw_d > 0 and decode_s > 0:
                self.decode_scale += a * (decode_s / raw_d - self.decode_scale)
            self.n_observed += 1

    def observe_selectivity(self, name: str, sel: float) -> None:
        """Fold a fused run's measured selectivity (Reduce count lane /
        n_rows) into the per-signature EWMA the fused-cost estimate uses."""
        with self._lock:
            p = self.profiles.get(name)
            if p is None or not p.signature:
                return
            sel = min(1.0, max(0.0, float(sel)))
            prev = self.selectivity.get(p.signature)
            if prev is None:
                self.selectivity[p.signature] = sel
            else:
                self.selectivity[p.signature] = prev + self.alpha * (sel - prev)

    def observe_link(self, link: int, ratio: float) -> None:
        """Fold one device leg's measured/predicted transfer ratio into the
        per-link EWMA scale ``topology.link_scale[link]``.

        The ratio is relative to the already-calibrated single-link model
        (``est_transfer_s`` folds ``transfer_scale`` in), so a symmetric mesh
        converges to ~1.0 per link while a slow leg (shared PCIe switch,
        throttled lane) drifts above its siblings and
        ``plan_mesh_execution``'s LPT loads + ``simulate_stream_multi``
        scoring shift bytes away from it.  The frozen ``LinkTopology`` is
        replaced atomically under the lock; persisted via ``save``'s
        "topology" block."""
        link = int(link)
        ratio = float(ratio)
        if not (ratio > 0.0) or not np.isfinite(ratio) or link < 0:
            return
        with self._lock:
            topo = self.topology
            scale = list(topo.link_scale)
            if len(scale) <= link:
                scale.extend([1.0] * (link + 1 - len(scale)))
            scale[link] += self.alpha * (ratio - scale[link])
            self.topology = dataclasses.replace(
                topo, n_links=max(topo.n_links, link + 1),
                link_scale=tuple(scale))

    def h2d_equiv_s(self, nbytes: int) -> float:
        """Calibrated host-link transfer time for ``nbytes`` -- the reference
        unit the D2D fabric tier is priced in (both
        ``LinkTopology.d2d_copy_s``'s argument and the denominator of
        ``observe_d2d`` samples)."""
        return (max(0, int(nbytes)) / (self.spec.host_link_gbps * 1e9)
                * self.transfer_scale)

    def observe_d2d(self, ratio: float) -> None:
        """Fold one device->device copy's measured/H2D-equivalent time ratio
        into the fabric EWMA ``topology.d2d_scale``.

        The ratio prices the D2D fabric relative to the calibrated host link
        for the same byte count: an NVLink-class fabric converges to ~0.1-0.2,
        a PCIe-P2P fabric to ~1.0.  The first valid sample seeds the scale
        (turning the fabric tier ON if the topology had none); later samples
        blend with the usual alpha.  Invalid samples (non-finite, <= 0) are
        dropped.  The frozen ``LinkTopology`` is replaced atomically under
        the lock and persists through ``save``'s "topology" block."""
        ratio = float(ratio)
        if not (ratio > 0.0) or not np.isfinite(ratio):
            return
        with self._lock:
            topo = self.topology
            if topo.d2d_scale is None:
                nxt = ratio
            else:
                nxt = topo.d2d_scale + self.alpha * (ratio - topo.d2d_scale)
            self.topology = dataclasses.replace(topo, d2d_scale=nxt)

    # -------------------------------------------------------- candidate ladder
    def chunk_ladder(self, p: ColumnProfile, max_candidates: int = 12
                     ) -> tuple[int, ...]:
        """Per-column chunk-size candidates (bytes), tied to this column's
        decode geometry instead of a fixed 64KiB-4MiB ladder.

        Element-chunkable columns snap to kernel tile multiples: doublings of
        lcm(boundary alignment, the chip's native <L,S,C> sub-tile S*C), so
        every decode launch covers whole kernel tiles.  Group-chunkable columns
        snap to group-boundary prefix sums: doublings of the group alignment,
        priced through the streamed bytes per group.  Both ladders are pruned
        with the CALIBRATED launch-overhead estimate -- a candidate whose
        per-chunk decode would be dominated by launch overhead is dropped, so
        the ladder tightens per pattern as the EWMA loop warms up."""
        if p.name not in self.profiles:
            self.register(p)
        _, d_est = self.predict(p.name)
        overhead = (p.n_kernels * self.spec.grid_step_overhead_ns * 1e-9
                    * self.decode_scale)
        cands: list[tuple[int, float]] = []   # (bytes, decode-work fraction)
        if p.chunkable and p.per_elem_bytes > 0 and p.n_out > 1:
            base = math.lcm(max(1, p.align),
                            native_subtile(p.pattern, self.spec.name))
            elems = base
            while elems < p.n_out and len(cands) < max_candidates:
                cands.append((max(1, math.ceil(elems * p.per_elem_bytes)),
                              elems / p.n_out))
                elems *= 2
        elif p.group_chunkable and p.group_bytes > 0 and p.n_groups > 1:
            g = max(1, p.group_align)
            while g < p.n_groups and len(cands) < max_candidates:
                cands.append((max(1, math.ceil(g * p.group_bytes)),
                              g / p.n_groups))
                g *= 2
        if not cands:
            return ()
        kept = [cb for cb, frac in cands
                if d_est <= 0 or d_est * frac >= 2.0 * overhead]
        return tuple(sorted(set(kept or [cands[-1][0]])))

    # ------------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        """Serialize the calibration state (EWMA scales + per-signature timing
        summaries) as JSON, so a fresh process plans from history -- the
        per-chip profile role the paper's per-GPU tuning plays."""
        data = {
            "chip": self.spec.name, "alpha": self.alpha,
            "transfer_scale": self.transfer_scale,
            "decode_scale": self.decode_scale,
            "n_observed": self.n_observed,
            "signatures": self.sig_stats,
            "selectivity": self.selectivity,
            "topology": self.topology.to_json(),
        }
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "CostModel":
        """Rebuild a CostModel from ``save`` output.  Profiles and per-column
        measurements are process-local and start empty; the calibration scales
        and signature histories carry over, so the very first plan of a fresh
        process is already in wall-clock units."""
        with open(path) as f:
            data = json.load(f)
        cm = cls(chip=data.get("chip", DEFAULT_CHIP),
                 alpha=float(data.get("alpha", 0.4)))
        cm.transfer_scale = float(data.get("transfer_scale", 1.0))
        cm.decode_scale = float(data.get("decode_scale", 1.0))
        cm.n_observed = int(data.get("n_observed", 0))
        cm.sig_stats = {
            sig: {"n": float(s.get("n", 0.0)),
                  "transfer_s": float(s.get("transfer_s", 0.0)),
                  "decode_s": float(s.get("decode_s", 0.0))}
            for sig, s in data.get("signatures", {}).items()}
        cm.selectivity = {sig: float(s)
                          for sig, s in data.get("selectivity", {}).items()}
        # tolerant topology parse: absent in old caches (-> single link),
        # unknown keys in future caches are ignored
        cm.topology = LinkTopology.from_json(data.get("topology"))
        return cm

    # ------------------------------------------------------------- job views
    def jobs(self, names: Sequence[str]) -> list[scheduler.Job]:
        """Scheduling jobs in CONSISTENT units.  Once the EWMA loop has been
        calibrated by at least one observation, each column uses its best
        prediction (measured if present, calibrated estimate otherwise) -- the
        same values ``predict`` hands the planner's per-column decisions.
        Before any calibration, mixing microsecond-scale raw estimates with
        millisecond-scale injected measurements would make Johnson's
        transfer-vs-decode comparison arbitrary, so it is all-or-nothing:
        measured only when every column has a measurement."""
        names = list(names)
        if self.n_observed or (names and all(n in self.measured
                                             for n in names)):
            est: Mapping[str, tuple[float, float]] = {
                n: self.predict(n) for n in names}
        else:
            est = {}
            for n in names:
                t, d = self.raw_estimate(n)
                est[n] = (t * self.transfer_scale, d * self.decode_scale)
        return [scheduler.Job(n, est[n][0], est[n][1]) for n in names]
