"""The port's scheduler (``repro_torch.core.scheduler``, a copy of the
reference's pure-Python module) against the JAX reference's, on the CPU.

Every function gives exactly the reference's result (``==`` on floats) on
hypothesis-drawn jobs, chunk infos, orders, windows and link tables, and the
properties the reference's own tests hold (``tests/test_scheduler.py`` and the
scheduler half of ``tests/test_planner.py``) hold on the port.
"""
import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import scheduler as R  # noqa: E402

from repro_torch.core import scheduler as S  # noqa: E402

times = st.floats(min_value=0.0, max_value=10.0, allow_nan=False)
pos_times = st.floats(min_value=0.01, max_value=10.0, allow_nan=False)
names = st.text(alphabet="ab#_", min_size=1, max_size=5)


@st.composite
def job_sets(draw, min_size=1, max_size=8, positive=False):
    t = pos_times if positive else times
    pairs = draw(st.lists(st.tuples(t, t), min_size=min_size, max_size=max_size))
    labels = draw(st.lists(names, min_size=len(pairs), max_size=len(pairs), unique=True))
    return [(n, a, b) for n, (a, b) in zip(labels, pairs)]


@st.composite
def info_tuples(draw):
    k = draw(st.integers(1, 6))
    weights = ()
    if draw(st.booleans()):
        weights = tuple(draw(st.lists(st.tuples(st.floats(0.0, 3.0), st.floats(0.0, 3.0)),
                                      min_size=k, max_size=k)))
    return (k, draw(st.booleans()), draw(st.floats(1e-3, 1.0)),
            draw(st.floats(0.0, 0.5)), weights)


@st.composite
def scenarios(draw, max_size=7):
    """Jobs, chunk infos, an order and a window."""
    jobs = draw(job_sets(max_size=max_size))
    infos = draw(st.lists(info_tuples(), min_size=len(jobs), max_size=len(jobs)))
    order = draw(st.permutations(range(len(jobs))))
    window = draw(st.one_of(st.none(), st.integers(1, 6)))
    return jobs, infos, list(order), window


def as_jobs(mod, jobs):
    return [mod.Job(n, a, b) for n, a, b in jobs]


def as_infos(mod, infos):
    return [mod.ChunkInfo(n_chunks=k, chunk_decode=cd, tail_frac=tf, launch_overhead_s=lo,
                          weights=w) for k, cd, tf, lo, w in infos]


def both(fn_name, *build):
    """``fn_name`` of the reference and of the port, each on its own objects."""
    return [getattr(mod, fn_name)(*(b(mod) for b in build)) for mod in (R, S)]


# ------------------------------------------------------------- exact parity

@settings(max_examples=80, deadline=None)
@given(job_sets(max_size=10))
def test_orders_makespan_and_serial_time_equal_reference(jobs):
    for fn in ("johnson_order", "fifo_order", "serial_time"):
        want, got = both(fn, lambda m: as_jobs(m, jobs))
        assert got == want, fn
    want, got = both("makespan", lambda m: as_jobs(m, jobs))
    assert got == want
    order = R.johnson_order(as_jobs(R, jobs))[::-1]
    assert S.makespan(as_jobs(S, jobs), order) == R.makespan(as_jobs(R, jobs), order)
    names_, a, b = zip(*jobs)
    assert S.schedule(names_, a, b) == R.schedule(names_, a, b)


@settings(max_examples=30, deadline=None)
@given(job_sets(max_size=5))
def test_brute_force_best_equals_reference(jobs):
    want, got = both("brute_force_best", lambda m: as_jobs(m, jobs))
    assert got == want


@settings(max_examples=80, deadline=None)
@given(job_sets(max_size=6), st.data())
def test_chunk_jobs_and_column_naming_equal_reference(jobs, data):
    ks = data.draw(st.lists(st.integers(1, 6), min_size=len(jobs), max_size=len(jobs)))
    tails = data.draw(st.one_of(st.none(), st.lists(st.floats(0.0, 1.5), min_size=len(jobs),
                                                    max_size=len(jobs))))
    want = R.chunk_jobs(as_jobs(R, jobs), ks, tails)
    got = S.chunk_jobs(as_jobs(S, jobs), ks, tails)
    assert [(j.name, j.transfer_s, j.decompress_s) for j in got] == \
        [(j.name, j.transfer_s, j.decompress_s) for j in want]
    chunk_names = [j.name for j in got]
    assert [S.column_of(n) for n in chunk_names] == [R.column_of(n) for n in chunk_names]
    assert S.column_order(chunk_names) == R.column_order(chunk_names)
    assert S.column_order(chunk_names) == [n for n, _, _ in jobs]   # '#' round-trips


@settings(max_examples=100, deadline=None)
@given(info_tuples())
def test_chunk_fractions_equal_reference(info):
    k = info[0]
    (ri,), (si,) = as_infos(R, [info]), as_infos(S, [info])
    assert S._chunk_fractions(si, k) == R._chunk_fractions(ri, k)


@settings(max_examples=120, deadline=None)
@given(scenarios())
def test_simulate_stream_equals_reference(sc):
    jobs, infos, order, window = sc
    rj, sj = as_jobs(R, jobs), as_jobs(S, jobs)
    ri, si = as_infos(R, infos), as_infos(S, infos)
    assert S.simulate_stream(sj, si, order, window) == \
        R.simulate_stream(rj, ri, order, window)
    assert S.simulate_stream_finish(sj, si, order, window) == \
        R.simulate_stream_finish(rj, ri, order, window)
    assert S.simulate_stream(sj) == R.simulate_stream(rj)


@settings(max_examples=100, deadline=None)
@given(scenarios(), st.data())
def test_simulate_stream_multi_equals_reference(sc, data):
    jobs, infos, order, window = sc
    n_links = data.draw(st.integers(1, 4))
    assignment = data.draw(st.lists(st.integers(0, n_links - 1), min_size=len(jobs),
                                    max_size=len(jobs)))
    scale = tuple(data.draw(st.lists(st.floats(0.5, 3.0), max_size=n_links)))
    latency = tuple(data.draw(st.lists(st.floats(0.0, 0.2), max_size=n_links)))
    host_window = data.draw(st.one_of(st.none(), st.integers(1, 5)))
    serial = data.draw(st.booleans())
    d2d = data.draw(st.one_of(st.none(), st.lists(
        st.tuples(st.integers(0, len(jobs) - 1), st.floats(0.0, 2.0)), max_size=3)))
    kw = dict(assignment=assignment, n_links=n_links, order=order, window=window,
              link_scale=scale, link_latency_s=latency, host_window=host_window,
              serial_issue=serial, d2d_copies=d2d)
    want = R.simulate_stream_multi(as_jobs(R, jobs), as_infos(R, infos), **kw)
    got = S.simulate_stream_multi(as_jobs(S, jobs), as_infos(S, infos), **kw)
    assert got == want


@settings(max_examples=80, deadline=None)
@given(scenarios())
def test_policies_equal_reference(sc):
    jobs, infos, _, _ = sc
    rj, sj = as_jobs(R, jobs), as_jobs(S, jobs)
    ri, si = as_infos(R, infos), as_infos(S, infos)
    for name in ("fifo", "johnson", "chunk-johnson", "adaptive"):
        rp, sp = R.get_policy(name), S.get_policy(name)
        assert sp.name == rp.name == name
        assert sp.order(sj, si) == rp.order(rj, ri), name
        assert sp.order(sj) == rp.order(rj), name
        assert sp.modeled_makespan(sj, si) == rp.modeled_makespan(rj, ri), name
    with pytest.raises(ValueError):
        S.get_policy("nope")
    pol = S.JohnsonPolicy()
    assert S.get_policy(pol) is pol


# ------------------------------------------- the reference's properties, on the port

@settings(max_examples=60, deadline=None)
@given(job_sets(max_size=6, positive=True))
def test_johnson_is_optimal(jobs):
    sj = as_jobs(S, jobs)
    best, _ = S.brute_force_best(sj)
    assert S.makespan(sj, S.johnson_order(sj)) <= best + 1e-9


@settings(max_examples=60, deadline=None)
@given(job_sets(max_size=8, positive=True))
def test_pipeline_bounds(jobs):
    sj = as_jobs(S, jobs)
    m = S.makespan(sj, S.johnson_order(sj))
    assert m <= S.serial_time(sj) + 1e-9
    assert m >= sum(j.transfer_s for j in sj) - 1e-9
    assert m >= max(j.transfer_s + j.decompress_s for j in sj) - 1e-9


def test_fig8_order_b_before_a():
    a = S.Job("A", transfer_s=4.0, decompress_s=1.0)
    b = S.Job("B", transfer_s=1.0, decompress_s=4.0)
    assert S.johnson_order([a, b]) == [1, 0]
    assert S.makespan([a, b], [1, 0]) < S.makespan([a, b], [0, 1])


def test_simulate_stream_defaults_reduce_to_makespan():
    rng = np.random.default_rng(0)
    jobs = [S.Job(str(i), float(a), float(b))
            for i, (a, b) in enumerate(rng.uniform(0.01, 5.0, (8, 2)))]
    order = S.johnson_order(jobs)
    assert S.simulate_stream(jobs, None, order) == pytest.approx(S.makespan(jobs, order))


def test_chunk_decode_never_worse_than_whole():
    rng = np.random.default_rng(1)
    for _ in range(50):
        jobs = [S.Job(str(i), float(a), float(b)) for i, (a, b)
                in enumerate(rng.uniform(0.01, 5.0, (rng.integers(1, 6), 2)))]
        ks = rng.integers(1, 9, len(jobs))
        whole = [S.ChunkInfo(n_chunks=int(k)) for k in ks]
        chunked = [S.ChunkInfo(n_chunks=int(k), chunk_decode=True) for k in ks]
        order = list(range(len(jobs)))
        assert S.simulate_stream(jobs, chunked, order) <= \
            S.simulate_stream(jobs, whole, order) + 1e-9


def test_chunk_jobs_uneven_tail_preserves_totals():
    jobs = [S.Job("a", 4.0, 2.0), S.Job("b", 1.0, 4.0)]
    cjobs = S.chunk_jobs(jobs, [4, 3], tail_frac=[0.25, 1.0])
    assert len(cjobs) == 7
    assert sum(j.transfer_s for j in cjobs) == pytest.approx(5.0)
    assert sum(j.decompress_s for j in cjobs) == pytest.approx(6.0)
    a_chunks = [j for j in cjobs if S.column_of(j.name) == "a"]
    assert a_chunks[-1].transfer_s == pytest.approx(a_chunks[0].transfer_s / 4)


def test_chunk_naming_escapes_separator():
    jobs = [S.Job("tbl#col", 2.0, 1.0), S.Job("plain", 1.0, 2.0)]
    cjobs = S.chunk_jobs(jobs, [3, 2])
    assert {S.column_of(j.name) for j in cjobs} == {"tbl#col", "plain"}
    assert S.column_order([j.name for j in cjobs]) == ["tbl#col", "plain"]
    assert S.column_of(S.chunk_jobs([S.Job("x#", 1, 1)], [2])[0].name) == "x#"


def test_adaptive_dominates_the_fixed_policies():
    rng = np.random.default_rng(2)
    for _ in range(30):
        n = int(rng.integers(2, 7))
        jobs = [S.Job(str(i), float(a), float(b))
                for i, (a, b) in enumerate(rng.uniform(0.01, 5.0, (n, 2)))]
        infos = [S.ChunkInfo(n_chunks=int(k), chunk_decode=bool(c))
                 for k, c in zip(rng.integers(1, 6, n), rng.integers(0, 2, n))]
        best = S.get_policy("adaptive").modeled_makespan(jobs, infos)
        for name in ("fifo", "johnson", "chunk-johnson"):
            assert best <= S.get_policy(name).modeled_makespan(jobs, infos) + 1e-12


def test_single_link_multi_reduces_to_simulate_stream_finish():
    rng = np.random.default_rng(3)
    jobs = [S.Job(str(i), float(a), float(b))
            for i, (a, b) in enumerate(rng.uniform(0.01, 5.0, (6, 2)))]
    infos = [S.ChunkInfo(n_chunks=int(k), chunk_decode=True) for k in rng.integers(1, 5, 6)]
    order = S.johnson_order(jobs)
    assert S.simulate_stream_multi(jobs, infos, order=order, window=3) == \
        S.simulate_stream_finish(jobs, infos, order, 3)
