"""The control at a size a test run holds: the reference computed one
precision lower, put in the program's place, comes out not correct, while
the program's own answers (the CPU's plain PyTorch path) come out correct."""
import pytest

from zfbench.data.tpch_gen import generate
from zfbench.lib import harness, registry, serve
from zfbench.reference import compare

BENCH = registry.benchmark()


@pytest.fixture(scope="module")
def q_setup():
    cell = registry.cell(registry.with_held(BENCH), "tpch-sf8-lineitem-q1q6.fused")
    cfg = registry.config(BENCH, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    return harness.build(cfg, traffic, seed=9, device="cpu", scale=0.01)


def test_query_program_passes_and_control_fails(q_setup):
    plain = q_setup.plain
    answers = []
    for q, qplan in sorted(q_setup.queries.items()):
        out = q_setup.pipe.run_query(qplan)
        answers.append((q, out.acc.numpy(), out.result))
    sound = compare.compare_queries(plain, answers)
    assert compare.within(sound), sound
    ctl = compare.compare_queries(plain, compare.control_query_answers(plain, ["q1", "q6"]))
    assert ctl["count_lane_mismatches"] == 0
    assert ctl["max_rel_err"] > 3 * compare.LIMITS["max_rel_err"]
    assert not compare.within(ctl)


def test_load_control_fails(q_setup):
    plain = q_setup.plain
    out = q_setup.pipe.run()
    sound = compare.compare_load(plain, [{n: r.array.numpy() for n, r in out.items()}])
    assert compare.within(sound), sound
    ctl = compare.compare_load(plain, [compare.control_load_answer(plain)])
    assert ctl["mismatched_elements"] > 0 and not compare.within(ctl)


def test_serve_control_fails():
    """One request of each query of the serve mix, the reference in the
    program's place: exact, it passes; one precision lower, it fails."""
    traffic = registry.traffic("serve")
    used = sorted({c for cols in traffic["queries"].values() for c in cols})
    plain = generate(0.01, 2**31 + 13, used)
    exact = [(names, {c: plain[c].copy() for c in names})
             for names in traffic["queries"].values()]
    assert compare.within(serve.readings(plain, exact, 0))
    ctl = serve.readings(plain, serve.control_answers(plain, traffic), 0)
    assert ctl["mismatched_elements"] > 0 and ctl["missing_columns"] == 0
    assert not compare.within(ctl)
