"""The benchmark's generator: the port's representation, and the rules of
TPC-H v3.0.1 clause 4.2.3."""
import numpy as np
import pytest

from repro_torch.data.tpch import generate as port_generate
from zfbench.data import tpch_gen
from zfbench.data.tpch_gen import COLUMNS, WORDS, _comment_text, generate

ORDERS = [c for c in COLUMNS if c.startswith("O_") and c != "O_COMMENT"]
PARTSUPP = [c for c in COLUMNS if c.startswith("PS_")]


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_generate_equals_port(seed):
    """The port's columns, in its order and types, and its table sizes: the
    Table-2 plans encode either."""
    want = port_generate(0.01, seed=seed)
    got = generate(0.01, seed=seed)
    assert list(got) == list(want) == list(COLUMNS)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
    for name in ORDERS + PARTSUPP:
        assert got[name].shape == want[name].shape, name
    assert len({got[c].size for c in COLUMNS if c.startswith("L_")}) == 1


@pytest.fixture(scope="module")
def table():
    return generate(0.01, seed=2**31 + 5)


def test_orders_follow_the_specification(table):
    t = table
    n = t["O_ORDERKEY"].size
    assert n == 15_000
    i = np.arange(n)
    assert np.array_equal(t["O_ORDERKEY"], (i // 8) * 32 + i % 8 + 1)
    assert t["O_CUSTKEY"].min() >= 1 and t["O_CUSTKEY"].max() <= 1_500
    assert not np.any(t["O_CUSTKEY"] % 3 == 0)
    assert t["O_ORDERDATE"].min() >= 8035 and t["O_ORDERDATE"].max() <= 10591 - 151
    assert not t["O_SHIPPRIORITY"].any()
    per_order = np.bincount(np.searchsorted(t["O_ORDERKEY"], t["L_ORDERKEY"]), minlength=n)
    assert per_order.min() == 1 and per_order.max() == 7
    line = (t["L_EXTENDEDPRICE"].astype(np.float64) * (1 + t["L_TAX"].astype(np.float64))
            * (1 - t["L_DISCOUNT"].astype(np.float64)))
    total = np.bincount(np.repeat(i, per_order), weights=line)
    # rounded to the cent, then stored as float32: off by half a cent and a float32 step
    step = np.spacing(total.astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(t["O_TOTALPRICE"] - total) <= 0.005 + step)


def test_lineitem_follows_the_specification(table):
    t = table
    odate = t["O_ORDERDATE"][np.searchsorted(t["O_ORDERKEY"], t["L_ORDERKEY"])]
    ship, commit, receipt = t["L_SHIPDATE"], t["L_COMMITDATE"], t["L_RECEIPTDATE"]
    for d, lo, hi in ((ship - odate, 1, 121), (commit - odate, 30, 90),
                      (receipt - ship, 1, 30)):
        assert d.min() == lo and d.max() == hi
    flag = t["L_RETURNFLAG"]
    assert np.all((flag == ord("N")) == (receipt > tpch_gen.CURRENTDATE))
    assert set(np.unique(flag[receipt <= tpch_gen.CURRENTDATE])) == {ord("A"), ord("R")}
    assert np.array_equal(t["L_LINESTATUS"], (ship > tpch_gen.CURRENTDATE).astype(np.int32))
    pk = t["L_PARTKEY"].astype(np.int64)
    assert pk.min() >= 1 and pk.max() <= 2_000
    retail = 90_000 + (pk // 10) % 20_001 + 100 * (pk % 1_000)
    assert np.array_equal(t["L_EXTENDEDPRICE"],
                          (t["L_QUANTITY"] * retail / 100.0).astype(np.float32))
    assert t["L_QUANTITY"].min() == 1 and t["L_QUANTITY"].max() == 50
    assert np.array_equal(np.unique(np.round(t["L_DISCOUNT"] * 100)), np.arange(11))
    assert np.array_equal(np.unique(np.round(t["L_TAX"] * 100)), np.arange(9))
    # each lineitem's supplier is one of its part's four, as PARTSUPP lists them
    ps = set(zip(t["PS_PARTKEY"].tolist(), t["PS_SUPPKEY"].tolist()))
    assert all(p in ps for p in zip(t["L_PARTKEY"].tolist(), t["L_SUPPKEY"].tolist()))
    assert np.array_equal(np.bincount(t["PS_PARTKEY"])[1:], np.full(2_000, 4))
    q1_share = np.mean(ship <= 10471)
    assert 0.97 < q1_share < 0.995                 # Q1 at DELTA 90 keeps about 98%


def test_comment_lengths_follow_the_specification(table):
    text = table["O_COMMENT"]
    ends = np.flatnonzero(text == ord("."))
    lens = np.diff(np.concatenate([[-1], ends]))
    assert lens.size == table["O_ORDERKEY"].size and ends[-1] == text.size - 1
    assert lens.min() == 19 and lens.max() == 79


def test_column_subset_equals_whole_table():
    whole = generate(0.01, seed=7)
    some = generate(0.01, seed=7, columns=["L_SHIPDATE", "L_TAX", "L_RETURNFLAG"])
    assert list(some) == ["L_TAX", "L_RETURNFLAG", "L_SHIPDATE"]
    for name, arr in some.items():
        assert arr.tobytes() == whole[name].tobytes()


def test_comment_text_matches_row_loop():
    n = 1000
    got = _comment_text(np.random.default_rng(3), n)
    rng = np.random.default_rng(3)
    length = rng.integers(19, 80, n)
    u = rng.random((n, 20))
    cdf = tpch_gen._word_cdf()
    rows = []
    for i in range(n):
        words = b"".join(WORDS[j] + b" " for j in np.searchsorted(cdf, u[i], side="right"))
        rows.append(words[:length[i] - 1] + b".")
    assert got.tobytes() == b"".join(rows)


def test_unknown_column_raises():
    with pytest.raises(KeyError):
        generate(0.01, seed=0, columns=["L_NOPE"])
