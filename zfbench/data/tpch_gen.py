"""The benchmark's TPC-H column generator, by the rules of the TPC-H
specification v3.0.1, clause 4.2.3, for the 24 columns of the ZipFlow
paper's Table 2.

    ORDERS    SF * 1,500,000 rows; O_ORDERKEY sparse (the first 8 keys of
              every 32); O_CUSTKEY in [1, SF * 150,000] and not divisible by
              3; O_ORDERDATE uniform in [STARTDATE, ENDDATE - 151 days];
              O_TOTALPRICE the sum over the order's lineitems of
              L_EXTENDEDPRICE * (1 + L_TAX) * (1 - L_DISCOUNT); O_SHIPPRIORITY
              0; O_COMMENT a text string of [19, 79] bytes.
    LINEITEM  1..7 rows an order; L_PARTKEY in [1, SF * 200,000]; L_SUPPKEY
              one of the part's 4 suppliers; L_QUANTITY in [1, 50];
              L_EXTENDEDPRICE = L_QUANTITY * P_RETAILPRICE(L_PARTKEY);
              L_DISCOUNT in [0.00, 0.10]; L_TAX in [0.00, 0.08];
              L_SHIPDATE = O_ORDERDATE + [1, 121]; L_COMMITDATE = O_ORDERDATE
              + [30, 90]; L_RECEIPTDATE = L_SHIPDATE + [1, 30];
              L_RETURNFLAG 'R' or 'A' at random where L_RECEIPTDATE <=
              CURRENTDATE, else 'N'; L_LINESTATUS 'O' where L_SHIPDATE >
              CURRENTDATE, else 'F'; L_SHIPINSTRUCT one of 4, L_SHIPMODE one of 7.
    PARTSUPP  4 rows a part: PS_PARTKEY, PS_SUPPKEY the part's i-th
              supplier; PS_AVAILQTY in [1, 9,999]; PS_SUPPLYCOST in [1.00, 1,000.00].

One departure: O_COMMENT's words come from a fixed list of 66 words with a
Zipf skew, not from the specification's text grammar (clause 4.2.2.10);
its lengths follow the specification.

Representation (the port's): low-cardinality string categoricals
(shipinstruct, shipmode, linestatus) are int32 dictionary codes in sorted
order (linestatus: 'F' 0, 'O' 1); RETURNFLAG is the raw uint8 character
stream; O_COMMENT is the uint8 text stream of the rows one after another,
each row's last byte a '.'; decimals are float32 with two decimal places;
dates are int32 days since 1970-01-01.

Each column draws from a random stream of its own (the seed and the
column's place), so any subset of columns equals the whole table's.
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

COLUMNS = (
    "L_ORDERKEY", "L_PARTKEY", "L_SUPPKEY", "L_QUANTITY", "L_EXTENDEDPRICE",
    "L_DISCOUNT", "L_TAX", "L_RETURNFLAG", "L_LINESTATUS", "L_SHIPDATE",
    "L_COMMITDATE", "L_RECEIPTDATE", "L_SHIPINSTRUCT", "L_SHIPMODE",
    "O_ORDERKEY", "O_CUSTKEY", "O_TOTALPRICE", "O_ORDERDATE", "O_SHIPPRIORITY",
    "O_COMMENT", "PS_PARTKEY", "PS_SUPPKEY", "PS_AVAILQTY", "PS_SUPPLYCOST")

# days since 1970-01-01 (clause 4.2.3)
STARTDATE = 8035          # 1992-01-01
CURRENTDATE = 9298        # 1995-06-17
ENDDATE = 10591           # 1998-12-31

COMMENT_LEN = (19, 79)    # O_COMMENT's length range, inclusive
_COMMENT_WORDS = 20       # words drawn a row: at least 80 bytes, over the longest row
_ROWS_PER_BLOCK = 1 << 18


def _word_cdf() -> np.ndarray:
    """The words' cumulative distribution: 7 in 10 drawn Zipf(1.6)-skewed
    (a Zipf draw folded onto the list), 3 in 10 uniformly."""
    k = np.arange(1, 1_000_001, dtype=np.float64)
    zipf = np.bincount((k.astype(np.int64) - 1) % len(WORDS), weights=k ** -1.6,
                       minlength=len(WORDS))
    p = 0.7 * zipf / zipf.sum() + 0.3 / len(WORDS)
    cdf = np.cumsum(p)
    return cdf / cdf[-1]


def _comment_text(rng, n_rows: int) -> np.ndarray:
    """Row i is the first ``length[i]`` bytes of its own stream of words,
    each word followed by a space, the row's last byte set to '.'; the rows
    one after another."""
    length = rng.integers(COMMENT_LEN[0], COMMENT_LEN[1] + 1, n_rows)
    toks = [w + b" " for w in WORDS]
    tok_bytes = np.frombuffer(b"".join(toks), np.uint8)
    tok_len = np.array([len(t) for t in toks], np.int64)
    tok_off = np.concatenate([[0], np.cumsum(tok_len)[:-1]])
    cdf = _word_cdf()
    parts = []
    for r0 in range(0, n_rows, _ROWS_PER_BLOCK):
        r1 = min(n_rows, r0 + _ROWS_PER_BLOCK)
        rows = r1 - r0
        ids = np.searchsorted(cdf, rng.random((rows, _COMMENT_WORDS)), side="right")
        ids = np.minimum(ids, len(WORDS) - 1)
        row_len = length[r0:r1]
        ends = np.cumsum(tok_len[ids], axis=1)            # bytes up to each word's end
        used = (ends < row_len[:, None]).sum(axis=1) + 1  # words that reach the row's length
        take = np.arange(_COMMENT_WORDS) < used[:, None]
        sel = ids[take]                                   # row-major: the words in order
        n = tok_len[sel]
        last = np.cumsum(used) - 1                        # each row's last word in ``sel``
        before = np.where(used > 1, ends[np.arange(rows), used - 2], 0)
        n[last] = row_len - before                        # the last word cut to the length
        start = np.cumsum(n) - n
        at = np.repeat(tok_off[sel] - start, n) + np.arange(int(n.sum()))
        text = tok_bytes[at]
        text[np.cumsum(row_len) - 1] = ord(".")
        parts.append(text)
    if not parts:
        return np.zeros(0, np.uint8)
    return np.concatenate(parts)


def retail_cents(partkey: np.ndarray) -> np.ndarray:
    """P_RETAILPRICE in cents: 90000 + ((key / 10) mod 20001) + 100 * (key mod 1000)."""
    k = partkey.astype(np.int64)
    return 90_000 + (k // 10) % 20_001 + 100 * (k % 1_000)


def supplier(partkey: np.ndarray, i: np.ndarray, n_supp: int) -> np.ndarray:
    """The part's i-th supplier (i in 0..3): (key + i * (S / 4 + (key - 1) / S))
    mod S + 1."""
    k = partkey.astype(np.int64)
    return (k + i * (n_supp // 4 + (k - 1) // n_supp)) % n_supp + 1


def generate(scale: float = 0.01, seed: int = 0,
             columns: list[str] | tuple[str, ...] | None = None) -> dict[str, np.ndarray]:
    """-> column name -> np.ndarray (those of ``columns``, or all 24).

    scale=1.0 is about 6M lineitems (SF 1)."""
    return dict(iter_columns(scale, seed, columns))


def iter_columns(scale: float, seed: int,
                 columns: list[str] | tuple[str, ...] | None = None):
    """``generate``'s columns one by one, each as soon as it is made: (name,
    array) in ``COLUMNS`` order."""
    want = set(COLUMNS if columns is None else columns)
    unknown = want - set(COLUMNS)
    if unknown:
        raise KeyError(f"no such generated column: {sorted(unknown)}")

    base = seed % 2**64

    def rng(stream: str):
        return np.random.default_rng([base, (COLUMNS + ("per_order",)).index(stream)])

    n_orders = max(int(1_500_000 * scale), 64)
    n_cust = max(int(150_000 * scale), 3)
    n_part = max(int(200_000 * scale), 4)
    n_supp = max(int(10_000 * scale), 4)
    memo: dict[str, np.ndarray] = {}

    def get(name: str) -> np.ndarray:
        if name not in memo:
            memo[name] = make[name]()
        return memo[name]

    def n_li() -> int:
        return int(get("per_order").sum())

    def per_line(order_col: str) -> np.ndarray:
        return np.repeat(get(order_col), get("per_order"))

    def cents(lo: int, hi: int, stream: str, n: int) -> np.ndarray:
        return (rng(stream).integers(lo, hi + 1, n) / 100.0).astype(np.float32)

    def shipdate():
        return (per_line("O_ORDERDATE") + rng("L_SHIPDATE").integers(1, 122, n_li())
                ).astype(np.int32)

    def receiptdate():
        return (get("L_SHIPDATE") + rng("L_RECEIPTDATE").integers(1, 31, n_li())
                ).astype(np.int32)

    def returnflag():
        ra = rng("L_RETURNFLAG").choice(np.frombuffer(b"RA", np.uint8), n_li())
        return np.where(get("L_RECEIPTDATE") <= CURRENTDATE, ra, ord("N")).astype(np.uint8)

    def extendedprice():
        c = get("L_QUANTITY").astype(np.int64) * retail_cents(get("L_PARTKEY"))
        return (c / 100.0).astype(np.float32)

    def totalprice():
        line = (get("L_EXTENDEDPRICE").astype(np.float64)
                * (1 + get("L_TAX").astype(np.float64))
                * (1 - get("L_DISCOUNT").astype(np.float64)))
        starts = np.concatenate([[0], np.cumsum(get("per_order"))[:-1]])
        return (np.round(np.add.reduceat(line, starts), 2)).astype(np.float32)

    def custkey():
        c = rng("O_CUSTKEY").integers(0, n_cust - n_cust // 3, n_orders)
        return (c + c // 2 + 1).astype(np.int32)       # the c-th key not divisible by 3

    def ps_partkey():
        return np.repeat(np.arange(1, n_part + 1, dtype=np.int32), 4)

    make = {
        "per_order": lambda: rng("per_order").integers(1, 8, n_orders),
        "O_ORDERKEY": lambda: ((np.arange(n_orders, dtype=np.int64) // 8) * 32
                               + np.arange(n_orders) % 8 + 1).astype(np.int32),
        "O_ORDERDATE": lambda: rng("O_ORDERDATE").integers(
            STARTDATE, ENDDATE - 151 + 1, n_orders).astype(np.int32),
        "L_ORDERKEY": lambda: per_line("O_ORDERKEY"),
        "L_PARTKEY": lambda: rng("L_PARTKEY").integers(1, n_part + 1, n_li()).astype(np.int32),
        "L_SUPPKEY": lambda: supplier(get("L_PARTKEY"), rng("L_SUPPKEY").integers(0, 4, n_li()),
                                      n_supp).astype(np.int32),
        "L_QUANTITY": lambda: rng("L_QUANTITY").integers(1, 51, n_li()).astype(np.int32),
        "L_EXTENDEDPRICE": extendedprice,
        "L_DISCOUNT": lambda: cents(0, 10, "L_DISCOUNT", n_li()),
        "L_TAX": lambda: cents(0, 8, "L_TAX", n_li()),
        "L_RETURNFLAG": returnflag,
        "L_LINESTATUS": lambda: (get("L_SHIPDATE") > CURRENTDATE).astype(np.int32),
        "L_SHIPDATE": shipdate,
        "L_COMMITDATE": lambda: (per_line("O_ORDERDATE")
                                 + rng("L_COMMITDATE").integers(30, 91, n_li())).astype(np.int32),
        "L_RECEIPTDATE": receiptdate,
        "L_SHIPINSTRUCT": lambda: rng("L_SHIPINSTRUCT").integers(0, 4, n_li()).astype(np.int32),
        "L_SHIPMODE": lambda: rng("L_SHIPMODE").integers(0, 7, n_li()).astype(np.int32),
        "O_CUSTKEY": custkey,
        "O_TOTALPRICE": totalprice,
        "O_SHIPPRIORITY": lambda: np.zeros(n_orders, np.int32),
        "O_COMMENT": lambda: _comment_text(rng("O_COMMENT"), n_orders),
        "PS_PARTKEY": ps_partkey,
        "PS_SUPPKEY": lambda: supplier(get("PS_PARTKEY"), np.tile(np.arange(4), n_part),
                                       n_supp).astype(np.int32),
        "PS_AVAILQTY": lambda: rng("PS_AVAILQTY").integers(1, 10_000, 4 * n_part)
        .astype(np.int32),
        "PS_SUPPLYCOST": lambda: cents(100, 100_000, "PS_SUPPLYCOST", 4 * n_part),
    }
    for name in COLUMNS:
        if name in want:
            yield name, get(name)
