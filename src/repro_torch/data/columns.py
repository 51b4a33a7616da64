"""Per-column nested compression plans (paper Table 2) + BtrBlocks-style auto chooser.

``TABLE2_PLANS`` transcribes the paper's custom nesting per TPC-H column into the
Plan IR (all 24 entries, as in the reference).  ``SLICE_COLUMNS`` are the 22 whose
codecs the port has today: every column but the rANS-backed L_RETURNFLAG and
O_COMMENT.  ``auto_plan`` searches a candidate pool by measured ratio (the
BtrBlocks role), skipping candidates whose codecs are not ported yet.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import registry
from repro_torch.core.plan import Plan, encode, make_plan

_bp = lambda: make_plan("bitpack")


def _dict_bp() -> Plan:
    return Plan("dictionary", children={"index": _bp()})


def _f2i_bp() -> Plan:
    return Plan("float2int", children={"ints": _bp()})


def _delta_bp() -> Plan:
    return Plan("delta", children={"deltas": _bp()})


def _deltastride_full() -> Plan:
    # paper: DeltaStride[Delta encoding|RLE[bp, bp], bp]
    return Plan("deltastride", children={
        "starts": _delta_bp(),
        "strides": _bp(),
        "counts": _bp()})


TABLE2_PLANS: dict[str, Plan] = {
    # --- plain bit-packing ---
    "L_SHIPINSTRUCT": _bp(), "L_SHIPMODE": _bp(), "L_SUPPKEY": _bp(),
    "L_PARTKEY": _bp(), "L_LINESTATUS": _bp(), "O_CUSTKEY": _bp(),
    "PS_AVAILQTY": _bp(), "L_QUANTITY": _bp(),
    # --- dictionary | bit-packing (dates) ---
    "L_COMMITDATE": _dict_bp(), "L_RECEIPTDATE": _dict_bp(),
    "L_SHIPDATE": _dict_bp(), "O_ORDERDATE": _dict_bp(),
    # --- Float2Int | bit-packing (decimals) ---
    "L_DISCOUNT": _f2i_bp(), "L_EXTENDEDPRICE": _f2i_bp(), "L_TAX": _f2i_bp(),
    "O_TOTALPRICE": _f2i_bp(), "PS_SUPPLYCOST": _f2i_bp(),
    # --- key columns (RLE / DeltaStride cascades) ---
    "L_ORDERKEY": Plan("rle", children={
        "values": _deltastride_full(), "counts": _bp()}),
    "O_ORDERKEY": _deltastride_full(),
    "PS_PARTKEY": Plan("rle", children={
        "values": _deltastride_full(), "counts": _bp()}),
    "PS_SUPPKEY": Plan("delta", children={
        "deltas": Plan("dictionary", children={"index": _bp()})}),
    "O_SHIPPRIORITY": Plan("rle", children={"counts": _bp(), "values": _bp()}),
    # --- entropy / strings (codecs not ported yet) ---
    "L_RETURNFLAG": make_plan("ans"),
    "O_COMMENT": Plan("stringdict", children={
        "index": Plan("bitpack", children={"packed": make_plan("ans")})}),
}

SLICE_COLUMNS: tuple[str, ...] = tuple(
    k for k in TABLE2_PLANS if k not in ("L_RETURNFLAG", "O_COMMENT"))


def _codecs(p: Plan) -> set[str]:
    out = {p.codec}
    for c in p.children.values():
        out |= _codecs(c)
    return out


def candidate_plans(arr: np.ndarray) -> list[Plan]:
    """Candidate pool by dtype, cheapest-first (BtrBlocks-style)."""
    if arr.dtype.kind == "f":
        return [_f2i_bp(), make_plan("ans"),
                Plan("float2int", children={"ints": _dict_bp()})]
    if arr.dtype == np.uint8:
        return [make_plan("ans"),
                Plan("stringdict", children={"index": _bp()}),
                TABLE2_PLANS["O_COMMENT"]]
    cands = [_bp(), _dict_bp(), _delta_bp(),
             Plan("rle", children={"counts": _bp(), "values": _bp()})]
    d = np.diff(arr.reshape(-1).astype(np.int64))
    if d.size and (d >= 0).mean() > 0.9:  # near-monotone: stride cascades apply
        cands += [_deltastride_full(),
                  Plan("rle", children={"values": _deltastride_full(),
                                        "counts": _bp()})]
    return cands


def auto_plan(arr: np.ndarray, sample: int = 1 << 16) -> tuple[Plan, float]:
    """Pick the best-ratio plan on a sample (returns (plan, full ratio estimate)).
    Candidates using a codec the port does not have are skipped."""
    flat = np.asarray(arr).reshape(-1)
    probe = flat[:sample]
    known = set(registry.names())
    best, best_ratio = None, -1.0
    for p in candidate_plans(flat):
        if not _codecs(p) <= known:
            continue
        try:
            enc = encode(p, probe)
        except (TypeError, ValueError):
            continue
        if enc.ratio > best_ratio:
            best, best_ratio = p, enc.ratio
    return best, best_ratio


def plan_for(name: str, arr: np.ndarray) -> Plan:
    if name in TABLE2_PLANS:
        return TABLE2_PLANS[name]
    return auto_plan(arr)[0]
