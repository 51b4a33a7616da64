"""Query-operator IR + QueryPlan-to-graph lowering (codec x operator fusion).

Late materialization: instead of decoding every column to device memory and
then running the engine over the materialized columns, a ``QueryPlan``
(compare/between predicates, arithmetic projections, predicated sums,
segment-sum group-by) lowers onto the columns' decode stages as operator
stages -- per-column predicate masks plus one terminal ``Reduce`` -- and
``fusion.fuse`` grafts the decode chains into them (rule 6).  The fused
graph's output is a partial aggregate (a few scalars or an 8-lane segment
accumulator), so the decompressed columns never reach device memory.

Predicates are evaluated in the compressed domain where the codec allows it:

  * bit-packed integers: compared on the packed field before the base is
    added (``algos.bitpack.compare_stage``: ``UNPACK_RAW -> RANGE``);
  * dictionary columns with a bit-packed index: value bounds map to dictionary
    *code* bounds (``algos.dictionary.code_bounds``, ``np.unique`` sorts the
    dictionary) and the code range is compared on the packed codes -- the
    dictionary gather never happens;
  * RLE columns: per run, run-length weighted (``algos.rle.run_reduce_graph``),
    never per row;
  * everything else (e.g. float2int decimals): fused post-decode -- the decode
    chain is grafted into the predicate stage (``TEST``), whose comparison uses
    the engine's arithmetic (the same masks).

Columns whose decode is not Fully-Parallel (rANS, RLE inside a multi-column
query) become **resident** inputs: decoded once by the executor's normal path
and read at the global row index by every fused chunk launch
(``BufSpec("row")``).

The reference's expressions evaluate on jnp arrays; here they evaluate on
torch tensors, whose promotion with Python scalars agrees with jnp's weak
typing (``Const(1) - L_DISCOUNT`` is float32, ``0.05`` is compared as
float32, an int32 column with a Python int stays int32).  ``%`` is floor
modulo in both (``torch.remainder``).  The expressions stay trees: the plain
version evaluates them with torch, and the query kernel runs a small program
compiled from them (``kernels/query_reduce.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core import fusion, ir as ir_mod, plan as plan_mod
from repro_torch.core.patterns import (MASK, ROW, VALUE, BufSpec, FullyParallel, Reduce,
                                       Role, Stage, load, predicate)


# ------------------------------------------------------------- expression IR

@dataclasses.dataclass(frozen=True)
class Col:
    """Column reference; ``cast`` converts on read (e.g. uint8 flag bytes
    entering integer arithmetic)."""

    name: str
    cast: str = ""

    def eval(self, env: Mapping[str, torch.Tensor]) -> torch.Tensor:
        v = env[self.name]
        return v.to(getattr(torch, self.cast)) if self.cast else v

    def cols(self) -> set[str]:
        return {self.name}

    def token(self) -> str:
        return f"col:{self.name}:{self.cast}"


@dataclasses.dataclass(frozen=True)
class Const:
    value: float

    def eval(self, env: Mapping[str, torch.Tensor]):
        return self.value          # python scalar: weak-typed, like the engine

    def cols(self) -> set[str]:
        return set()

    def token(self) -> str:
        return f"const:{self.value!r}"


@dataclasses.dataclass(frozen=True)
class Bin:
    """Binary arithmetic node; op in '+', '-', '*', '%'."""

    op: str
    a: Any
    b: Any

    def eval(self, env: Mapping[str, torch.Tensor]):
        x, y = self.a.eval(env), self.b.eval(env)
        if self.op == "+":
            return x + y
        if self.op == "-":
            return x - y
        if self.op == "*":
            return x * y
        if self.op == "%":
            return x % y
        raise ValueError(f"unknown op {self.op!r}")

    def cols(self) -> set[str]:
        return self.a.cols() | self.b.cols()

    def token(self) -> str:
        return f"({self.a.token()}{self.op}{self.b.token()})"


@dataclasses.dataclass(frozen=True)
class Pred:
    """Range predicate on one column; op in '<', '<=', '>=', '>', 'between'
    (inclusive both ends, like SQL BETWEEN)."""

    col: str
    op: str
    value: Any
    value2: Any = None

    def mask(self, v: torch.Tensor) -> torch.Tensor:
        if self.op == "<":
            return v < self.value
        if self.op == "<=":
            return v <= self.value
        if self.op == ">=":
            return v >= self.value
        if self.op == ">":
            return v > self.value
        if self.op == "between":
            return (v >= self.value) & (v <= self.value2)
        raise ValueError(f"unknown predicate op {self.op!r}")

    def int_range(self) -> tuple[int | None, int | None] | None:
        """As a half-open integer range [lo, hi), or None if not exact."""
        def ok(x):
            return x is not None and float(x) == int(x)
        if self.op == "<" and ok(self.value):
            return None, int(self.value)
        if self.op == "<=" and ok(self.value):
            return None, int(self.value) + 1
        if self.op == ">=" and ok(self.value):
            return int(self.value), None
        if self.op == ">" and ok(self.value):
            return int(self.value) + 1, None
        if self.op == "between" and ok(self.value) and ok(self.value2):
            return int(self.value), int(self.value2) + 1
        return None

    def token(self) -> str:
        return f"pred:{self.col}:{self.op}:{self.value!r}:{self.value2!r}"


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """A scan-filter-aggregate query: ANDed predicates, mask-weighted sum
    aggregates, optional segment-sum group-by.  A trailing selected-row count
    lane is always computed (selectivity feedback for the cost model);
    ``keep_count_lane`` includes it in the result (TPC-H Q1's count(*) lane)."""

    name: str
    predicates: tuple[Pred, ...] = ()
    aggregates: tuple[tuple[str, Any], ...] = ()    # (label, Expr)
    group_key: Any = None                           # Expr -> int32 segment ids
    n_segments: int = 1
    keep_count_lane: bool = False

    def columns(self) -> list[str]:
        seen: list[str] = []
        for p in self.predicates:
            if p.col not in seen:
                seen.append(p.col)
        for _, e in self.aggregates:
            for c in sorted(e.cols()):
                if c not in seen:
                    seen.append(c)
        if self.group_key is not None:
            for c in sorted(self.group_key.cols()):
                if c not in seen:
                    seen.append(c)
        return seen

    def digest(self) -> str:
        toks = [self.name, str(self.n_segments), str(self.keep_count_lane)]
        toks += [p.token() for p in self.predicates]
        toks += [f"{lbl}={e.token()}" for lbl, e in self.aggregates]
        if self.group_key is not None:
            toks.append(f"key={self.group_key.token()}")
        return hashlib.sha1("|".join(toks).encode()).hexdigest()[:16]


# ------------------------------------------------------------------ lowering

def _all_fp(stages: list[Stage]) -> bool:
    return all(isinstance(st, FullyParallel) for st in stages)


def _merge_ranges(preds: tuple[Pred, ...]) -> tuple[int | None, int | None] | None:
    lo: int | None = None
    hi: int | None = None
    for p in preds:
        r = p.int_range()
        if r is None:
            return None
        plo, phi = r
        if plo is not None:
            lo = plo if lo is None else max(lo, plo)
        if phi is not None:
            hi = phi if hi is None else min(hi, phi)
    return lo, hi


def _compressed_domain_mask(col: str, enc, lo, hi) -> FullyParallel | None:
    """Range mask on the packed field, or None if unsupported."""
    from repro_torch.algos import bitpack as bp_mod
    from repro_torch.algos import dictionary as dict_mod

    if enc.codec == "bitpack":
        return bp_mod.compare_stage(
            enc, f"{col}.packed", f"{col}.@bit_width", f"{col}.@base",
            f"{col}.mask", lo, hi)
    if enc.codec == "dictionary":
        child = enc.children.get("index")
        if child is None or child.codec != "bitpack":
            return None
        clo, chi = dict_mod.code_bounds(enc.buffers["dictionary"], lo, hi)
        return bp_mod.compare_stage(
            child, f"{col}/index.packed", f"{col}/index.@bit_width",
            f"{col}/index.@base", f"{col}.mask", clo, chi)
    return None


@dataclasses.dataclass
class FusedQuery:
    """A lowered, fused query: one Reduce-terminated DecodeGraph over the
    fusible columns plus the names of resident columns."""

    qplan: QueryPlan
    graph: ir_mod.DecodeGraph
    operands: dict[str, np.ndarray]      # leaf buffers + meta operands (host)
    fused_cols: tuple[str, ...]
    resident: tuple[str, ...]            # columns fed decoded ("row" inputs)
    n_rows: int
    n_lanes: int                         # aggregates + the count lane
    n_segments: int
    prefuse_stages: list[Stage] = dataclasses.field(default_factory=list)

    def resident_input(self, col: str) -> str:
        return f"{col}.resident"

    def finalize(self, acc):
        """Partial-sum accumulator -> the engine-shaped result."""
        if self.qplan.group_key is None:
            vec = acc[: self.n_lanes - 1]
            return vec[0] if self.n_lanes == 2 else vec
        mat = acc.reshape(self.n_lanes, self.n_segments)
        return mat if self.qplan.keep_count_lane else mat[:-1]

    def selected_rows(self, acc) -> float:
        return float(np.sum(np.asarray(acc[-self.n_segments:])))

    def selectivity(self, acc) -> float:
        return self.selected_rows(acc) / max(self.n_rows, 1)


def _decoded_dtype(enc) -> np.dtype:
    """The dtype the executor decodes a column to (its graph's output)."""
    return np.dtype(plan_mod.lower(enc)[-1].out_dtype)


def lower_query(qplan: QueryPlan, encs: Mapping[str, Any]) -> FusedQuery:
    """Lower a QueryPlan over compressed columns to a fused DecodeGraph.

    ``encs`` maps column name -> ``plan.Encoded``; every column the query
    touches must be present and all columns must share the row count.
    """
    cols = qplan.columns()
    for c in cols:
        if c not in encs:
            raise KeyError(f"query {qplan.name} needs column {c!r}")
    n_rows = int(encs[cols[0]].n)
    for c in cols:
        if int(encs[c].n) != n_rows:
            raise ValueError(f"column {c} has {encs[c].n} rows, expected {n_rows}")

    value_cols: set[str] = set()
    for _, e in qplan.aggregates:
        value_cols |= e.cols()
    if qplan.group_key is not None:
        value_cols |= qplan.group_key.cols()

    stages: list[Stage] = []
    roles: list[Role] = []
    inline_preds: list[Pred] = []
    fused_cols: list[str] = []
    resident: list[str] = []

    for col in cols:
        enc = encs[col]
        preds = tuple(p for p in qplan.predicates if p.col == col)
        dec_stages = plan_mod.lower(enc, prefix=col, out_name=f"{col}.val")
        if not _all_fp(dec_stages):
            resident.append(col)
            roles.append(Role(ROW, col, (load(f"{col}.resident"),), _decoded_dtype(enc)))
            inline_preds += list(preds)
            continue
        fused_cols.append(col)
        val_dtype = dec_stages[-1].out_dtype
        if preds and col not in value_cols:
            rng = _merge_ranges(preds)
            cmask = (_compressed_domain_mask(col, enc, *rng)
                     if rng is not None else None)
            if cmask is not None:
                stages.append(cmask)         # decode chain elided entirely
                roles.append(Role(MASK, col, (load(cmask.out),), np.bool_))
                continue
            # fused post-decode mask stage (grafted into the decode by rule 6)
            stages += dec_stages
            mst = FullyParallel(
                chain=(load(f"{col}.val"), predicate(preds, val_dtype)),
                inputs=(f"{col}.val",), specs=(BufSpec("tile"),), out=f"{col}.mask",
                n_out=n_rows, out_dtype=np.bool_, elementwise=False,
                name=f"pred[{col}]", positional=True)
            stages.append(mst)
            roles.append(Role(MASK, col, (load(mst.out),), np.bool_))
        else:
            stages += dec_stages
            roles.append(Role(VALUE, col, (load(f"{col}.val"),), val_dtype))
            inline_preds += list(preds)

    n_lanes = len(qplan.aggregates) + 1     # + selected-row count lane
    S = int(qplan.n_segments)
    red = Reduce(
        roles=tuple(roles), inputs=tuple(r.chain[0].bufs[0] for r in roles),
        specs=tuple(BufSpec("row") if r.kind == ROW else BufSpec("tile") for r in roles),
        lanes=tuple(e for _, e in qplan.aggregates), key=qplan.group_key,
        preds=tuple(inline_preds), n_segments=S, n_in=n_rows,
        out=f"{qplan.name}.agg", n_out=n_lanes * S, name=f"reduce[{qplan.name}]")
    stages.append(red)

    prefuse = list(stages)
    fused = fusion.fuse(stages, final_out=red.out)

    # only ship what the fused program actually reads (a compressed-domain
    # predicate elides e.g. the dictionary buffer along with the decode)
    used: set[str] = set()
    for st in fused:
        used.update(getattr(st, "inputs", ()))
    operands: dict[str, np.ndarray] = {}
    buffers: list[ir_mod.BufferDef] = []
    meta_specs: list[ir_mod.MetaSpec] = []
    h = hashlib.sha1()
    for col in fused_cols:
        enc = encs[col]
        h.update(f"{col}:{ir_mod.structural_signature(enc)}".encode())
        for k, v in plan_mod.flat_buffers(enc, prefix=col).items():
            if k in used:
                operands[k] = v
                buffers.append(ir_mod.BufferDef(
                    name=k, shape=tuple(v.shape), dtype=np.dtype(v.dtype).str))
        for k, v in plan_mod.meta_operands(enc, prefix=col).items():
            if k in used:
                operands[k] = v
                meta_specs.append(ir_mod.MetaSpec(
                    name=k, shape=tuple(v.shape), dtype=np.dtype(v.dtype).str))
    for col in resident:
        h.update(f"row:{col}:{np.dtype(encs[col].dtype).str}".encode())
    h.update(qplan.digest().encode())

    graph = ir_mod.DecodeGraph(
        stages=fused, buffers=tuple(buffers), out=red.out,
        n_out=int(red.n_out), out_dtype="<f4",
        signature=h.hexdigest() + "+qfused", meta_specs=tuple(meta_specs),
        nesting=f"query[{qplan.name}]", fused=True)
    return FusedQuery(
        qplan=qplan, graph=graph, operands=operands,
        fused_cols=tuple(fused_cols), resident=tuple(resident),
        n_rows=n_rows, n_lanes=n_lanes, n_segments=S, prefuse_stages=prefuse)
