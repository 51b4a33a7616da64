"""A query of the benchmark, ``zfbench/queries/<name>.json``, built into the
port's public ``QueryPlan``.

The file states the query as data: ``predicates`` as ``[column, op, value]``
(or ``[column, "between", lo, hi]``), ``aggregates`` as ``[label, expr]``,
an optional ``group_key`` expr with ``n_segments``, and ``keep_count_lane``.
An expr is a number (a constant), ``["col", name]`` or ``["col", name,
cast]``, or ``[op, expr, expr]`` with op one of ``+ - * %``.
"""
from __future__ import annotations


def _expr(e):
    from repro_torch.core.query import Bin, Col, Const

    if isinstance(e, (int, float)) and not isinstance(e, bool):
        return Const(e)
    if e[0] == "col":
        return Col(*e[1:])
    op, a, b = e
    if op not in ("+", "-", "*", "%"):
        raise ValueError(f"no such operator {op!r} in a query expression")
    return Bin(op, _expr(a), _expr(b))


def plan(spec: dict):
    """The port's ``QueryPlan`` of a query file's contents."""
    from repro_torch.core.query import Pred, QueryPlan

    key = spec.get("group_key")
    return QueryPlan(
        name=spec["name"],
        predicates=tuple(Pred(*p) for p in spec.get("predicates", ())),
        aggregates=tuple((label, _expr(e)) for label, e in spec.get("aggregates", ())),
        group_key=None if key is None else _expr(key),
        n_segments=int(spec.get("n_segments", 1)),
        keep_count_lane=bool(spec.get("keep_count_lane", False)))
