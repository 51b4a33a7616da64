"""Decode-graph IR: the program representation between Plan and executor.

``plan.lower_graph`` produces a ``DecodeGraph`` from a compressed blob and
``fusion.fuse_graph`` rewrites it; the compiler consumes graphs.  A graph carries
the stage list plus:

  * **buffer defs** -- name/shape/dtype of every leaf buffer that moves host->device;
  * **meta specs** -- the *lifted* data-dependent metadata (bitpack ``bit_width``/
    ``base``, delta ``base``) that enters the program as runtime operands,
    identified by name/dtype/shape only;
  * **output spec** -- final buffer name, length, dtype;
  * **structural signature** -- a digest of the codec tree, structural metadata,
    leaf shapes/dtypes and lifted-operand specs.  Equal signatures lower to
    interchangeable programs, so one compiled program serves all such blobs.  The
    digest is byte-identical to the reference package's for the same blob.

The chunk analyses below (``element_chunk_layout``, ``group_chunk_layout``,
and ``query_chunk_layout`` for a fused query's item axis) say how a graph
splits for streamed decode.  They read only the stages' buffer
names and ``BufSpec`` tiles (a Group-Parallel stage's ``value_inputs``, which
fusion rule 2 may have replaced by a bit-packed producer's inputs; a
Non-Parallel stage's ``streams``/``states``), never the op chains, so they
come out equal to the reference's on every field a schedule reads.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Iterator, TYPE_CHECKING

import numpy as np

from repro_torch.core import registry
from repro_torch.core.patterns import (CHUNK_ELEMENT, CHUNK_GROUP, CHUNK_NONE,
                                       BufSpec, FullyParallel, GroupParallel,
                                       NonParallel, Reduce, Stage, stage_inputs)

if TYPE_CHECKING:  # avoid a hard import cycle with repro_torch.core.plan
    from repro_torch.core.plan import Encoded


@dataclasses.dataclass(frozen=True)
class BufferDef:
    """One leaf buffer of a compressed blob (what actually transfers)."""

    name: str                 # hierarchical name, e.g. "root/index.packed"
    shape: tuple[int, ...]
    dtype: str                # numpy dtype string


@dataclasses.dataclass(frozen=True)
class MetaSpec:
    """One lifted meta operand: program identity is (name, shape, dtype) -- never
    the value.  The value rides along at call time as a tiny device buffer."""

    name: str                 # hierarchical operand name, e.g. "root.@bit_width"
    shape: tuple[int, ...]
    dtype: str


@dataclasses.dataclass
class DecodeGraph:
    """A lowered (possibly fused) decode program: stages over named buffers."""

    stages: list[Stage]
    buffers: tuple[BufferDef, ...]   # leaf inputs, in lowering order
    out: str                         # final output buffer name
    n_out: int
    out_dtype: str
    signature: str                   # structural digest (see module docstring)
    meta_specs: tuple[MetaSpec, ...] = ()   # lifted runtime operands
    nesting: str = ""                # human-readable codec nesting, e.g. "rle[bp]"
    fused: bool = False

    @property
    def n_kernels(self) -> int:
        """Stages of the graph: the decode launches the cost model counts."""
        return len(self.stages)

    @property
    def chunkability(self) -> str:
        """Finest output boundary the executor can split this graph at:
        CHUNK_ELEMENT if every stage splits anywhere, CHUNK_GROUP when
        ``group_chunk_layout`` finds a group-boundary recipe, else CHUNK_NONE."""
        levels = {st.chunkability for st in self.stages}
        if not levels:
            return CHUNK_NONE
        if levels == {CHUNK_ELEMENT}:
            return CHUNK_ELEMENT
        return CHUNK_GROUP if group_chunk_layout(self) is not None else CHUNK_NONE


# ------------------------------------------------------------------- signature

def _meta_tokens(meta: dict[str, Any], lifted: dict[str, Any],
                 host: tuple[str, ...] = ()) -> Iterator[str]:
    for k in sorted(meta):
        if k in lifted:
            # a runtime operand: dtype/shape are identity, the value is not
            yield f"{k}~operand:{np.dtype(lifted[k]).str}:(1,)"
            continue
        if k in host:
            # host planning meta (per-group offsets): dtype/shape only
            v = np.asarray(meta[k])
            yield f"{k}~host:{v.dtype.str}:{tuple(v.shape)}"
            continue
        v = meta[k]
        if isinstance(v, np.ndarray):
            digest = hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()[:12]
            yield f"{k}=nd{v.shape}{v.dtype}:{digest}"
        elif isinstance(v, (bool, int, float, str, np.integer, np.floating)):
            yield f"{k}={v!r}"
        elif isinstance(v, (tuple, list)):
            yield f"{k}={type(v).__name__}{tuple(v)!r}"
        else:
            # unknown meta types cannot be content-hashed; refusing beats a silent
            # signature collision that would share a program with wrong constants
            raise TypeError(
                f"cannot signature meta value {k!r} of type {type(v).__name__}; "
                "use scalars, strings, tuples/lists, or ndarrays")


def _encoded_tokens(enc: "Encoded") -> Iterator[str]:
    yield f"codec={enc.codec};n={enc.n};dtype={np.dtype(enc.dtype).str}"
    codec = registry.get(enc.codec)
    lifted = getattr(codec, "lifted_meta", {})
    host = tuple(getattr(codec, "host_meta", ()))
    yield from _meta_tokens(enc.meta, lifted, host)
    for name in sorted(enc.buffers):
        b = enc.buffers[name]
        yield f"buf:{name}:{tuple(b.shape)}:{np.dtype(b.dtype).str}"
    for slot in sorted(enc.children):
        yield f"child:{slot}("
        yield from _encoded_tokens(enc.children[slot])
        yield ")"


def structural_signature(enc: "Encoded") -> str:
    """Digest of codec tree + structural metadata + leaf shapes/dtypes + lifted
    operand specs (equal signatures <=> interchangeable programs)."""
    h = hashlib.sha1()
    for tok in _encoded_tokens(enc):
        h.update(tok.encode())
        h.update(b"\x00")
    return h.hexdigest()


def describe_encoded(enc: "Encoded") -> str:
    """Nesting string in the paper's Table-2 notation, from the blob side."""
    if not enc.children:
        return enc.codec
    inner = ", ".join(f"{k}={describe_encoded(v)}" for k, v in enc.children.items())
    return f"{enc.codec}[{inner}]"


def graph_from_encoded(enc: "Encoded", stages: list[Stage]) -> DecodeGraph:
    """Assemble a DecodeGraph around an already-lowered stage list."""
    from repro_torch.core import plan as plan_mod

    flat = plan_mod.flat_buffers(enc)
    buffers = tuple(BufferDef(name=k, shape=tuple(v.shape),
                              dtype=np.dtype(v.dtype).str)
                    for k, v in flat.items())
    ops = plan_mod.meta_operands(enc)
    meta_specs = tuple(MetaSpec(name=k, shape=tuple(v.shape),
                                dtype=np.dtype(v.dtype).str)
                       for k, v in ops.items())
    final = stages[-1]
    return DecodeGraph(
        stages=list(stages), buffers=buffers, out=final.out,
        n_out=int(final.n_out), out_dtype=np.dtype(final.out_dtype).str,
        signature=structural_signature(enc), meta_specs=meta_specs,
        nesting=describe_encoded(enc))


# ------------------------------------------------------- element-chunk analysis

@dataclasses.dataclass(frozen=True)
class ChunkLayout:
    """Slicing recipe for element-chunkable graphs.

    Every chunk boundary is a multiple of ``align`` (the lcm of the tile
    denominators, so every input slice is integral and a bit-packed chunk starts
    at word 0 of its own slice).  ``tiled`` maps each tile leaf to its BufSpec;
    ``whole`` lists what every chunk shares (full-resident tables and the lifted
    meta operands)."""

    align: int
    tiled: dict[str, Any]      # leaf name -> BufSpec (ratio may be operand-driven)
    whole: tuple[str, ...]


def element_chunk_layout(graph: DecodeGraph) -> ChunkLayout | None:
    """The slicing recipe for per-chunk decode, or None.

    A graph decodes per chunk iff every stage is Fully-Parallel over the full
    output length, every tile input is a 1-D leaf sliced in proportion or an
    intermediate consumed positionally, and some leaf is tiled."""
    if graph.chunkability != CHUNK_ELEMENT:
        return None
    produced: set[str] = set()
    tiled: dict[str, Any] = {}
    whole: list[str] = []
    buf_shapes = {b.name: b.shape for b in graph.buffers}
    align = 1
    for st in graph.stages:
        if not isinstance(st, FullyParallel) or int(st.n_out) != int(graph.n_out):
            return None
        for name, spec in zip(st.inputs, st.specs):
            if name in produced:
                if spec.kind == "tile" and (spec.num, spec.den) != (1, 1):
                    return None
                continue
            if spec.kind == "full":
                if name not in whole:
                    whole.append(name)
                continue
            if name in tiled:
                if tiled[name] != spec:   # two ratios on one leaf
                    return None
                continue
            if len(buf_shapes.get(name, (0, 0))) != 1:
                return None               # only 1-D leaves slice along axis 0
            tiled[name] = spec
            align = math.lcm(align, int(spec.den))
        produced.add(st.out)
    if not tiled:
        return None
    for ms in graph.meta_specs:          # (1,) scalars always ride whole
        if ms.name not in whole and ms.name not in tiled:
            whole.append(ms.name)
    return ChunkLayout(align=align, tiled=dict(tiled), whole=tuple(whole))


# --------------------------------------------------------- query-chunk analysis

@dataclasses.dataclass(frozen=True)
class QueryChunkLayout:
    """Per-chunk partial-aggregate recipe for a fused query graph.

    The item axis being chunked is the terminal Reduce's ``n_in`` (rows, or RLE
    runs) -- not ``graph.n_out``, which is the tiny accumulator.  ``tiled`` and
    ``whole`` follow ``ChunkLayout`` over that axis; ``resident`` lists "row"
    inputs: decoded columns kept whole on the device and read at the global
    item index by every chunk launch."""

    align: int
    tiled: dict[str, Any]       # leaf name -> BufSpec over the item axis
    whole: tuple[str, ...]
    resident: tuple[str, ...]
    n_rows: int                 # item-axis length partial launches cover


def query_chunk_layout(graph: DecodeGraph) -> QueryChunkLayout | None:
    """The per-chunk partial-aggregate recipe of a fused query graph, or None.

    Eligible iff the final stage is a ``Reduce`` and every earlier stage is
    Fully-Parallel over the full item axis (``n_out == reduce.n_in``), so a
    chunk of items maps to the same element range at every stage.  Memoised
    per graph, like ``group_chunk_layout``."""
    cached = graph.__dict__.get("_query_layout", False)
    if cached is not False:
        return cached
    layout = _query_chunk_layout(graph)
    graph.__dict__["_query_layout"] = layout
    return layout


def _query_chunk_layout(graph: DecodeGraph) -> QueryChunkLayout | None:
    stages = graph.stages
    if not stages or not isinstance(stages[-1], Reduce):
        return None
    red = stages[-1]
    n_rows = int(red.n_in)
    if n_rows <= 0:
        return None
    produced: set[str] = set()
    tiled: dict[str, Any] = {}
    whole: list[str] = []
    resident: list[str] = []
    buf_shapes = {b.name: b.shape for b in graph.buffers}
    align = 1
    for st in stages:
        if st is not red and (not isinstance(st, FullyParallel)
                              or int(st.n_out) != n_rows):
            return None
        for name, spec in zip(st.inputs, st.specs):
            if name in produced:
                if spec.kind == "tile" and (spec.num, spec.den) != (1, 1):
                    return None
                continue
            if spec.kind == "row":
                if name not in resident:
                    resident.append(name)
                continue
            if spec.kind == "full":
                if name not in whole:
                    whole.append(name)
                continue
            if name in tiled:
                if tiled[name] != spec:
                    return None
                continue
            if len(buf_shapes.get(name, (0, 0))) != 1:
                return None
            tiled[name] = spec
            align = math.lcm(align, int(spec.den))
        produced.add(st.out)
    if not tiled:
        return None
    for ms in graph.meta_specs:
        if ms.name not in whole and ms.name not in tiled:
            whole.append(ms.name)
    return QueryChunkLayout(align=align, tiled=dict(tiled), whole=tuple(whole),
                            resident=tuple(resident), n_rows=n_rows)


# --------------------------------------------------------- group-chunk analysis

@dataclasses.dataclass(frozen=True)
class GroupChunkLayout:
    """Recipe for group-boundary streamed decode.

    The graph splits at its last Group-Parallel or Non-Parallel stage: every
    stage before it is the **prologue**, decoded once over whole-resident leaves,
    and the group stage (with any trailing positional Fully-Parallel stages)
    launches once per span of whole groups.  ``sliced`` maps each leaf read per
    group to its BufSpec (RLE values at ``num/den`` rows per group, rANS states
    one row per group, rANS stream stripes one *column* per group: ``axes``);
    ``resident`` names prologue outputs the span launches read at global group
    indices.  ``group_presum`` is the encoder's per-group output offset table
    (``n_groups + 1`` entries); ``elems_per_group > 0`` marks uniform groups
    (rANS chunks), whose spans need no padding.  ``host_push`` holds buffers
    staged from host metadata instead of computed by a prologue (StringDict's
    presum), and ``span_graft`` maps a Group-Parallel value input to the
    Fully-Parallel producer each span re-evaluates over its sliced leaf."""

    kind: str                     # "gp" | "np"
    stage_index: int
    n_groups: int
    elems_per_group: int
    sliced: dict[str, Any]
    axes: dict[str, int]
    whole: tuple[str, ...]
    resident: tuple[str, ...]
    align_groups: int
    group_presum: Any = dataclasses.field(default=None, compare=False)
    host_push: dict[str, Any] = dataclasses.field(default_factory=dict, compare=False)
    span_graft: dict[str, int] = dataclasses.field(default_factory=dict)


def _post_stages_ok(graph: DecodeGraph, g_idx: int) -> bool:
    """Stages after the group stage must be Fully-Parallel over the full output,
    reading the group stage's output positionally and everything else whole."""
    produced = {st.out for st in graph.stages[: g_idx + 1]}
    for st in graph.stages[g_idx + 1:]:
        if not isinstance(st, FullyParallel) or int(st.n_out) != int(graph.n_out):
            return False
        for name, spec in zip(st.inputs, st.specs):
            if name in produced:
                if spec.kind != "tile" or spec.num_op:
                    return False
            elif spec.kind != "full":
                return False
        produced.add(st.out)
    return True


def group_chunk_layout(graph: DecodeGraph) -> GroupChunkLayout | None:
    """The group-boundary streaming recipe, or None (whole-column decode).

    One group stage (the last Group-Parallel or Non-Parallel), trailing stages
    positional Fully-Parallel, the encoder's group metadata present, and at
    least one leaf that slices per group.  A second pass allows span-time
    grafts of a bit-packed producer.  Memoised per graph (graphs are not
    changed after lowering and fusion; ``dataclasses.replace`` drops the memo)."""
    cached = graph.__dict__.get("_group_layout", False)
    if cached is not False:
        return cached
    layout = _group_chunk_layout(graph)
    if layout is None:
        layout = _group_chunk_layout(graph, graft=True)
    graph.__dict__["_group_layout"] = layout
    return layout


def _group_chunk_layout(graph: DecodeGraph,
                        graft: bool = False) -> GroupChunkLayout | None:
    stages = graph.stages
    g_idx = -1
    for i, st in enumerate(stages):
        if isinstance(st, (GroupParallel, NonParallel)):
            g_idx = i
    if g_idx < 0 or int(graph.n_out) <= 0:
        return None
    gst = stages[g_idx]
    if not _post_stages_ok(graph, g_idx):
        return None
    leaf_shapes = {b.name: b.shape for b in graph.buffers}
    produced_before = {st.out for st in stages[:g_idx]}
    sliced: dict[str, Any] = {}
    axes: dict[str, int] = {}
    align = 1
    resident: list[str] = []
    span_graft: dict[str, int] = {}

    def _resident(name: str) -> None:
        if name in produced_before and name not in resident:
            resident.append(name)

    if isinstance(gst, GroupParallel):
        n_groups = int(gst.n_groups)
        presum = gst.host_group_presum
        if presum is None or n_groups <= 0:
            return None
        presum = np.asarray(presum)
        if presum.shape != (n_groups + 1,) or int(presum[-1]) != int(gst.n_out):
            return None
        if int(gst.n_out) != int(graph.n_out):
            return None
        _resident(gst.presum)
        if gst.presum not in produced_before and gst.presum not in leaf_shapes:
            return None
        meta_names = {ms.name for ms in graph.meta_specs}
        producer = {st.out: i for i, st in enumerate(stages[:g_idx])}

        def _graft_idx(name: str) -> int | None:
            """The producer of ``name`` when each span can re-evaluate it over a
            sliced leaf: a Fully-Parallel stage at group granularity whose first
            input is a 1-D tiled leaf and whose other inputs are whole."""
            gi = producer.get(name)
            if gi is None:
                return None
            p = stages[gi]
            if not isinstance(p, FullyParallel) or int(p.n_out) != n_groups:
                return None
            if (not p.inputs or p.inputs[0] not in leaf_shapes
                    or len(leaf_shapes[p.inputs[0]]) != 1 or p.specs[0].kind != "tile"):
                return None
            if any(sp.kind != "full" for sp in p.specs[1:]):
                return None
            if any(i not in leaf_shapes and i not in meta_names for i in p.inputs[1:]):
                return None
            return gi

        for name, spec in zip(gst.value_inputs, gst.value_specs):
            # operand-driven ratios (bitpack's bit width) slice too: den=32
            # aligns every span start to a whole word
            if name in leaf_shapes and spec.kind == "tile" and len(leaf_shapes[name]) == 1:
                sliced[name] = spec
                axes[name] = 0
                align = math.lcm(align, int(spec.den))
                continue
            gi = None
            if (graft and spec.kind == "tile" and not spec.num_op
                    and int(spec.num) == 1 and int(spec.den) == 1):
                gi = _graft_idx(name)
            if gi is not None:
                p = stages[gi]
                sliced[p.inputs[0]] = p.specs[0]
                axes[p.inputs[0]] = 0
                align = math.lcm(align, int(p.specs[0].den))
                span_graft[name] = gi
            else:
                _resident(name)
        for name in gst.extra_inputs:
            _resident(name)
        elems_per_group = 0
    else:                        # NonParallel: the groups are the rANS chunks
        n_groups = int(gst.n_chunks)
        cs = int(gst.chunk_size)
        if n_groups <= 0 or cs <= 0:
            return None
        if len(leaf_shapes.get(gst.streams, ())) != 2 \
                or len(leaf_shapes.get(gst.states, ())) != 1:
            return None
        # bytes -> final elements: a trailing byte-reassemble widens by its num
        itemsize = 1
        for st in stages[g_idx + 1:]:
            for name, spec in zip(st.inputs, st.specs):
                if name == gst.out:
                    itemsize = int(spec.num) // max(1, int(spec.den))
        if itemsize <= 0 or cs % itemsize:
            return None
        sliced[gst.streams] = BufSpec("tile")
        axes[gst.streams] = 1    # stripe: one column per group
        sliced[gst.states] = BufSpec("tile")
        axes[gst.states] = 0
        elems_per_group = cs // itemsize
        presum = np.minimum(np.arange(n_groups + 1, dtype=np.int64) * elems_per_group,
                            int(graph.n_out))
        if int(presum[-1]) != int(graph.n_out):
            return None
    if n_groups <= 1 or not sliced:
        return None
    for st in stages[g_idx + 1:]:
        for name in st.inputs:
            _resident(name)
    # The prologue runs over whole buffers before span 0, so it may read no
    # sliced leaf: un-slice on conflict -- unless the prologue exists only to
    # recompute the presum the encoder already emitted (StringDict's word
    # lengths read the index leaf whole).  Then that table is pushed from the
    # host with the whole buffers, no prologue runs, and the leaf stays sliced.
    pro_inputs: set[str] = set()
    for st in stages[:g_idx]:
        pro_inputs.update(stage_inputs(st))
    host_push: dict[str, Any] = {}
    conflict = [name for name in sliced if name in pro_inputs]
    if conflict and isinstance(gst, GroupParallel) and resident == [gst.presum]:
        prod = next(st for st in stages[:g_idx] if st.out == gst.presum)
        host_push[gst.presum] = np.asarray(presum).astype(np.dtype(prod.out_dtype))
        resident = []
    else:
        for name in conflict:
            del sliced[name]
            axes.pop(name, None)
    if not sliced:
        return None
    # a graft needs its leaf still sliced and its value not needed resident
    for nm, gi in span_graft.items():
        if stages[gi].inputs[0] not in sliced or nm in resident:
            return None
    whole = tuple([b.name for b in graph.buffers if b.name not in sliced]
                  + [ms.name for ms in graph.meta_specs] + list(host_push))
    return GroupChunkLayout(
        kind="gp" if isinstance(gst, GroupParallel) else "np",
        stage_index=g_idx, n_groups=n_groups, elems_per_group=elems_per_group,
        sliced=dict(sliced), axes=dict(axes), whole=whole, resident=tuple(resident),
        align_groups=align, group_presum=np.asarray(presum, dtype=np.int64),
        host_push=host_push, span_graft=dict(span_graft))
