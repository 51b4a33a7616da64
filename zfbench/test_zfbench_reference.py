"""The NumPy references of Q1 and Q6 against a row-by-row computation, and
the comparison's arithmetic."""
import numpy as np
import pytest

from zfbench.reference import compare
from zfbench.reference.precision import round_bfloat16
from zfbench.reference.queries import q1, q6


def tiny(seed=0, n=400):
    rng = np.random.default_rng(seed)
    return {
        "L_RETURNFLAG": rng.choice(np.frombuffer(b"NAR", np.uint8), n),
        "L_LINESTATUS": rng.integers(0, 2, n).astype(np.int32),
        "L_QUANTITY": rng.integers(1, 51, n).astype(np.int32),
        "L_EXTENDEDPRICE": (rng.integers(90000, 10500000, n) / 100.0).astype(np.float32),
        "L_DISCOUNT": (rng.integers(0, 11, n) / 100.0).astype(np.float32),
        "L_TAX": (rng.integers(0, 9, n) / 100.0).astype(np.float32),
        "L_SHIPDATE": rng.integers(8700, 10600, n).astype(np.int32),
    }


def test_q1_row_by_row():
    c = tiny()
    groups = {}
    for i in range(len(c["L_SHIPDATE"])):
        if c["L_SHIPDATE"][i] > 10471:                  # 1998-12-01 - 90 days
            continue
        g = groups.setdefault((chr(c["L_RETURNFLAG"][i]), "FO"[c["L_LINESTATUS"][i]]),
                              np.zeros(6))
        p, d, t = (float(c[x][i]) for x in ("L_EXTENDEDPRICE", "L_DISCOUNT", "L_TAX"))
        g += (float(c["L_QUANTITY"][i]), p, p * (1 - d), p * (1 - d) * (1 + t), d, 1.0)
    assert len(groups) == 6
    got = q1.lanes(c)
    segment = {"A": 0, "R": 2, "N": 3}
    want = np.zeros((6, 8))
    for (flag, status), g in groups.items():
        want[:, segment[flag] * 2 + "FO".index(status)] = g
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert not got[:, [2, 3]].any()                  # no flag maps to segment 1


def test_q6_row_by_row():
    c = tiny(1, 2000)
    rev = cnt = 0.0
    for i in range(len(c["L_SHIPDATE"])):
        d = c["L_DISCOUNT"][i]
        if (8766 <= c["L_SHIPDATE"][i] < 9131 and np.float32(0.05) <= d <= np.float32(0.07)
                and c["L_QUANTITY"][i] < 24):
            rev += float(c["L_EXTENDEDPRICE"][i]) * float(d)
            cnt += 1
    got = q6.lanes(c)
    assert got.shape == (2, 1) and got[1, 0] == cnt and cnt > 0
    np.testing.assert_allclose(got[0, 0], rev, rtol=1e-12)


def test_round_bfloat16():
    x = np.array([1.0, 0.05, 0.07, 3.0e5, -2.5], np.float32)
    r = round_bfloat16(x)
    assert np.all(r.view(np.uint32) & 0xFFFF == 0)
    assert np.all(np.abs(r - x) <= np.abs(x) * 2.0 ** -8)
    assert r[0] == 1.0 and r[4] == -2.5


def test_compare_load_counts_bits():
    plain = {"a": np.arange(10, dtype=np.int32), "b": np.linspace(0, 1, 5, dtype=np.float32)}
    same = {k: v.copy() for k, v in plain.items()}
    assert compare.compare_load(plain, [same])["mismatched_elements"] == 0
    off = {k: v.copy() for k, v in plain.items()}
    off["a"][3] += 1
    off["b"][0] = -0.0                      # equal as a float, not as bits
    got = compare.compare_load(plain, [off, same])
    assert got["mismatched_elements"] == 2 and got["missing_columns"] == 0
    got = compare.compare_load(plain, [{"a": plain["a"]}])
    assert got["missing_columns"] == 1 and got["mismatched_elements"] == 5
    assert compare.compare_load(plain, [])["missing_answers"] == 1


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_compare_queries(q):
    c = tiny(2, 3000)
    ref = compare.reference_lanes(c, [q])
    lanes = ref[q]
    acc = lanes.astype(np.float32).reshape(-1)
    res = lanes if q == "q1" else np.float32(lanes[0, 0])
    ok = compare.compare_queries(c, [(q, acc, res)], ref)
    assert ok["count_lane_mismatches"] == 0 and ok["max_rel_err"] < 1e-6
    bad = acc.copy()
    bad[-1] += 1                             # a count off by one
    assert compare.compare_queries(c, [(q, bad, res)], ref)["count_lane_mismatches"] == 1
    bad = acc.copy()
    bad[0] *= 1.01
    assert compare.compare_queries(c, [(q, bad, res)], ref)["max_rel_err"] > 5e-3
