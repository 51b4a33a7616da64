"""Synthetic TPC-H-style data generator (dbgen distributions, scaled-down).

A copy of the reference package's ``repro/data/tpch.py``: the same seed gives the
same columns in both packages.

Generates the columns of the three largest tables (LINEITEM, ORDERS, PARTSUPP) the
paper compresses (Table 2).  Value distributions follow the TPC-H spec shapes:
sparse monotone order keys, 1-7 lineitems per order, ~2500 distinct dates, 2-decimal
prices, skewed flag frequencies, comment text from a finite word pool.

Representation notes (recorded for honesty):
  * low-cardinality *string* categoricals (shipinstruct, shipmode, linestatus) are
    stored as int32 dictionary codes -- the paper's Table 2 bit-packs them directly,
    which implies the same pre-dictionarized representation;
  * RETURNFLAG is the raw uint8 character stream (ANS target);
  * COMMENT columns are uint8 text streams (String-dictionary target).
"""
from __future__ import annotations

import numpy as np

WORDS = [w.encode() for w in (
    "the quick silver fox express packages deposits accounts regular carefully "
    "slyly furiously ironic requests theodolites pending asymptotes foxes bold "
    "final platelets blithely daring instructions unusual even special about "
    "above according across after against along among around beside between "
    "customer order ship deliver economy machine metal steel brass copper tin "
    "nickel small large medium jumbo wrap bag box pack case carton").split()]


def _comment_text(rng, n_rows: int, avg_words: int = 8) -> np.ndarray:
    n_words = n_rows * avg_words
    idx = rng.integers(0, len(WORDS), n_words)
    # zipf-ish skew: first words far more common
    skew = rng.zipf(1.6, n_words) % len(WORDS)
    idx = np.where(rng.random(n_words) < 0.7, skew, idx)
    parts = []
    for i in range(n_rows):
        ws = [WORDS[j] for j in idx[i * avg_words:(i + 1) * avg_words]]
        parts.append(b" ".join(ws) + b". ")
    return np.frombuffer(b"".join(parts), dtype=np.uint8).copy()


def generate(scale: float = 0.01, seed: int = 0) -> dict[str, np.ndarray]:
    """-> column name -> np.ndarray.  scale=1.0 ~ 6M lineitems (dbgen SF=1)."""
    rng = np.random.default_rng(seed)
    n_orders = max(int(1_500_000 * scale), 64)
    per_order = rng.integers(1, 8, n_orders)              # 1..7 lineitems/order
    n_li = int(per_order.sum())
    n_ps = max(int(800_000 * scale), 64)

    # sparse monotone order keys (dbgen leaves gaps)
    o_orderkey = np.cumsum(rng.integers(1, 4, n_orders)).astype(np.int32)
    l_orderkey = np.repeat(o_orderkey, per_order).astype(np.int32)

    dates = rng.integers(8035, 10591, n_orders)           # ~2556 distinct days
    date_li = np.repeat(dates, per_order) + rng.integers(0, 90, n_li)

    def money(lo, hi, n):
        return (rng.integers(lo * 100, hi * 100, n) / 100.0).astype(np.float32)

    cols = {
        # --- LINEITEM ---
        "L_ORDERKEY": l_orderkey,
        "L_PARTKEY": rng.integers(1, max(int(200_000 * scale), 1000), n_li)
        .astype(np.int32),
        "L_SUPPKEY": rng.integers(1, max(int(10_000 * scale), 100), n_li)
        .astype(np.int32),
        "L_QUANTITY": rng.integers(1, 51, n_li).astype(np.int32),
        "L_EXTENDEDPRICE": money(900, 105_000, n_li),
        "L_DISCOUNT": (rng.integers(0, 11, n_li) / 100.0).astype(np.float32),
        "L_TAX": (rng.integers(0, 9, n_li) / 100.0).astype(np.float32),
        "L_RETURNFLAG": rng.choice(
            np.frombuffer(b"NAR", dtype=np.uint8), n_li,
            p=[0.5, 0.25, 0.25]).astype(np.uint8),
        "L_LINESTATUS": rng.integers(0, 2, n_li).astype(np.int32),
        "L_SHIPDATE": (date_li + rng.integers(1, 122, n_li)).astype(np.int32),
        "L_COMMITDATE": (date_li + rng.integers(30, 91, n_li)).astype(np.int32),
        "L_RECEIPTDATE": (date_li + rng.integers(1, 31, n_li)).astype(np.int32),
        "L_SHIPINSTRUCT": rng.integers(0, 4, n_li).astype(np.int32),
        "L_SHIPMODE": rng.integers(0, 7, n_li).astype(np.int32),
        # --- ORDERS ---
        "O_ORDERKEY": o_orderkey,
        "O_CUSTKEY": rng.integers(1, max(int(150_000 * scale), 1000), n_orders)
        .astype(np.int32),
        "O_TOTALPRICE": money(850, 550_000, n_orders),
        "O_ORDERDATE": dates.astype(np.int32),
        "O_SHIPPRIORITY": np.zeros(n_orders, np.int32),
        "O_COMMENT": _comment_text(rng, n_orders),
        # --- PARTSUPP ---
        "PS_PARTKEY": np.repeat(np.arange(1, n_ps // 4 + 2, dtype=np.int32), 4)
        [:n_ps],
        "PS_SUPPKEY": (np.tile(np.arange(4, dtype=np.int32), n_ps // 4 + 1)[:n_ps]
                       * max(int(2_500 * scale), 25)
                       + rng.integers(1, max(int(2_500 * scale), 25), n_ps))
        .astype(np.int32),
        "PS_AVAILQTY": rng.integers(1, 10_000, n_ps).astype(np.int32),
        "PS_SUPPLYCOST": money(1, 1_000, n_ps),
    }
    return cols


# monotone integer key columns: tiling must add a per-tile offset so the keys
# keep growing (delta/delta-stride codecs see realistic small deltas, not one
# huge negative jump per tile)
_MONOTONE_KEYS = {"L_ORDERKEY", "O_ORDERKEY"}


def scale_columns(cols: dict[str, np.ndarray], factor: int,
                  names: list[str] | None = None) -> dict[str, np.ndarray]:
    """Tile generated columns ``factor``x toward SF>=1 row counts.

    Value distributions are preserved exactly (each tile is the original
    data); monotone key columns get a cumulative per-tile offset so they stay
    sorted-monotone and keep their delta structure.  Columns not in ``names``
    pass through untouched, so a benchmark can scale only the lineitem columns
    a query reads without exploding unrelated text columns."""
    factor = max(1, int(factor))
    out: dict[str, np.ndarray] = {}
    for name, arr in cols.items():
        if factor == 1 or (names is not None and name not in names):
            out[name] = arr
            continue
        if name in _MONOTONE_KEYS and arr.size:
            span = int(arr[-1]) - int(arr[0]) + 1
            tiles = [arr + np.asarray(t * span, dtype=arr.dtype)
                     for t in range(factor)]
            out[name] = np.concatenate(tiles)
        else:
            out[name] = np.tile(arr, factor)
    return out


# Columns touched by each TPC-H query (L/O/PS tables only -- the paper's scope).
QUERY_COLUMNS: dict[int, list[str]] = {
    1: ["L_RETURNFLAG", "L_LINESTATUS", "L_QUANTITY", "L_EXTENDEDPRICE",
        "L_DISCOUNT", "L_TAX", "L_SHIPDATE"],
    2: ["PS_PARTKEY", "PS_SUPPKEY", "PS_SUPPLYCOST"],
    3: ["L_ORDERKEY", "L_EXTENDEDPRICE", "L_DISCOUNT", "L_SHIPDATE",
        "O_ORDERKEY", "O_CUSTKEY", "O_ORDERDATE", "O_SHIPPRIORITY"],
    4: ["L_ORDERKEY", "L_COMMITDATE", "L_RECEIPTDATE", "O_ORDERKEY",
        "O_ORDERDATE"],
    5: ["L_ORDERKEY", "L_SUPPKEY", "L_EXTENDEDPRICE", "L_DISCOUNT",
        "O_ORDERKEY", "O_CUSTKEY", "O_ORDERDATE"],
    6: ["L_EXTENDEDPRICE", "L_DISCOUNT", "L_QUANTITY", "L_SHIPDATE"],
    7: ["L_ORDERKEY", "L_SUPPKEY", "L_EXTENDEDPRICE", "L_DISCOUNT",
        "L_SHIPDATE", "O_ORDERKEY", "O_CUSTKEY"],
    8: ["L_ORDERKEY", "L_PARTKEY", "L_SUPPKEY", "L_EXTENDEDPRICE",
        "L_DISCOUNT", "O_ORDERKEY", "O_CUSTKEY", "O_ORDERDATE"],
    9: ["L_ORDERKEY", "L_PARTKEY", "L_SUPPKEY", "L_QUANTITY",
        "L_EXTENDEDPRICE", "L_DISCOUNT", "O_ORDERKEY", "O_ORDERDATE",
        "PS_PARTKEY", "PS_SUPPKEY", "PS_SUPPLYCOST"],
    10: ["L_ORDERKEY", "L_EXTENDEDPRICE", "L_DISCOUNT", "L_RETURNFLAG",
         "O_ORDERKEY", "O_CUSTKEY", "O_ORDERDATE"],
    11: ["PS_PARTKEY", "PS_SUPPKEY", "PS_AVAILQTY", "PS_SUPPLYCOST"],
    12: ["L_ORDERKEY", "L_SHIPMODE", "L_COMMITDATE", "L_RECEIPTDATE",
         "L_SHIPDATE", "O_ORDERKEY"],
    13: ["O_ORDERKEY", "O_CUSTKEY", "O_COMMENT"],
    14: ["L_PARTKEY", "L_EXTENDEDPRICE", "L_DISCOUNT", "L_SHIPDATE"],
    15: ["L_SUPPKEY", "L_EXTENDEDPRICE", "L_DISCOUNT", "L_SHIPDATE"],
    16: ["PS_PARTKEY", "PS_SUPPKEY"],
    17: ["L_PARTKEY", "L_QUANTITY", "L_EXTENDEDPRICE"],
    18: ["L_ORDERKEY", "L_QUANTITY", "O_ORDERKEY", "O_CUSTKEY",
         "O_TOTALPRICE", "O_ORDERDATE"],
    19: ["L_PARTKEY", "L_QUANTITY", "L_EXTENDEDPRICE", "L_DISCOUNT",
         "L_SHIPINSTRUCT", "L_SHIPMODE"],
    20: ["L_PARTKEY", "L_SUPPKEY", "L_QUANTITY", "L_SHIPDATE",
         "PS_PARTKEY", "PS_SUPPKEY", "PS_AVAILQTY"],
    21: ["L_ORDERKEY", "L_SUPPKEY", "L_COMMITDATE", "L_RECEIPTDATE",
         "O_ORDERKEY"],
    22: ["O_ORDERKEY", "O_CUSTKEY", "O_TOTALPRICE"],
}
