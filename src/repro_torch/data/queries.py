"""TPC-H Q1 and Q6: the materialize-then-query engines in torch, and the same
queries as declarative ``QueryPlan``s (``core.query``).

``q1_engine`` / ``q6_engine`` run over decoded columns (the paper's baseline:
decode every column to device memory, then scan it).  ``Q1_PLAN`` / ``Q6_PLAN``
lower onto the columns' decode graphs, so scan-filter-aggregate runs inside the
per-chunk decode launch and only partial aggregates reach device memory.

Each segment of Q1's group-by is one ``torch.sum`` over the rows of that key
(``jax.ops.segment_sum`` in the reference; keys outside ``[0, 8)`` are dropped
there and here), so the engines sum in a fixed order on every device.
"""
from __future__ import annotations

import torch

from repro_torch.core.query import Bin, Col, Const, Pred, QueryPlan


def _segment_sum(v: torch.Tensor, key: torch.Tensor, n: int) -> torch.Tensor:
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([torch.where(key == s, v, zero).sum() for s in range(n)])


def q1_engine(c: dict[str, torch.Tensor]) -> torch.Tensor:
    """TPC-H Q1: filtered group-by aggregates over lineitem."""
    sel = c["L_SHIPDATE"] <= 10000
    # RETURNFLAG is the raw character stream ('N'/'A'/'R'); fold to a group code
    flag = (c["L_RETURNFLAG"].to(torch.int32) - 65) % 4
    key = flag * 2 + c["L_LINESTATUS"]
    disc_price = c["L_EXTENDEDPRICE"] * (1 - c["L_DISCOUNT"])
    charge = disc_price * (1 + c["L_TAX"])
    w = sel.to(torch.float32)
    out = []
    for v in (c["L_QUANTITY"].to(torch.float32), c["L_EXTENDEDPRICE"],
              disc_price, charge, w):
        out.append(_segment_sum(v * w, key, 8))
    return torch.stack(out)


def q6_engine(c: dict[str, torch.Tensor]) -> torch.Tensor:
    """TPC-H Q6: predicated revenue sum."""
    sel = ((c["L_SHIPDATE"] >= 8766) & (c["L_SHIPDATE"] < 9131)
           & (c["L_DISCOUNT"] >= 0.05) & (c["L_DISCOUNT"] <= 0.07)
           & (c["L_QUANTITY"] < 24))
    zero = torch.zeros((), dtype=torch.float32, device=sel.device)
    return torch.where(sel, c["L_EXTENDEDPRICE"] * c["L_DISCOUNT"], zero).sum()


ENGINES = {1: q1_engine, 6: q6_engine}


# --------------------------------------------------- declarative QueryPlan IR

_DISC_PRICE = Bin("*", Col("L_EXTENDEDPRICE"),
                  Bin("-", Const(1), Col("L_DISCOUNT")))

# lane order matches q1_engine: quantity, extendedprice, disc_price, charge,
# and the always-computed count lane doubles as the engine's ``w`` lane
Q1_PLAN = QueryPlan(
    name="q1",
    predicates=(Pred("L_SHIPDATE", "<=", 10000),),
    aggregates=(
        ("sum_qty", Col("L_QUANTITY", "float32")),
        ("sum_base_price", Col("L_EXTENDEDPRICE")),
        ("sum_disc_price", _DISC_PRICE),
        ("sum_charge", Bin("*", _DISC_PRICE,
                           Bin("+", Const(1), Col("L_TAX")))),
    ),
    group_key=Bin("+", Bin("*", Bin("%", Bin("-", Col("L_RETURNFLAG", "int32"),
                                             Const(65)),
                                   Const(4)),
                           Const(2)),
                  Col("L_LINESTATUS")),
    n_segments=8,
    keep_count_lane=True)

Q6_PLAN = QueryPlan(
    name="q6",
    predicates=(Pred("L_SHIPDATE", ">=", 8766),
                Pred("L_SHIPDATE", "<", 9131),
                Pred("L_DISCOUNT", "between", 0.05, 0.07),
                Pred("L_QUANTITY", "<", 24)),
    aggregates=(("revenue", Bin("*", Col("L_EXTENDEDPRICE"),
                                Col("L_DISCOUNT"))),))

QUERY_PLANS = {1: Q1_PLAN, 6: Q6_PLAN}
