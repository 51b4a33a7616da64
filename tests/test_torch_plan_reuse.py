"""``StreamingExecutor.plan``'s one-entry plan memo on the CPU: a call with the
same key gets a copy of the last search's plan while the priced inputs (each
column's predicted transfer + decode time, and ``decode_scale``) stay within
``planner.REPLAN_DRIFT`` of what the search priced or of what the plan's
first run measured; any key field, a new profile, the first calibration or a
larger drift searches again."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import plan as P
from repro_torch.core.planner import REPLAN_DRIFT
from repro_torch.core.executor import StreamingExecutor
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.tpch import generate

COLUMNS = ("L_DISCOUNT", "L_TAX", "L_SHIPDATE", "L_QUANTITY", "O_COMMENT")
BIG = "O_COMMENT"
DECODE_RATIO = 0.01         # every column's measured decode / raw chip-model decode


@pytest.fixture(scope="module")
def cols():
    data = generate(0.002, seed=0)
    return {c: data[c] for c in COLUMNS}


@pytest.fixture(scope="module")
def encs(cols):
    return {c: P.encode(TABLE2_PLANS[c], cols[c]) for c in COLUMNS}


def executor(encs) -> StreamingExecutor:
    ex = StreamingExecutor("torch", "cpu", policy="adaptive", chunk_bytes="auto",
                           chunk_decode=True)
    for c in COLUMNS:
        ex.compile(c, encs[c])
    return ex


def timings(ex, name: str, jitter: float = 0.0) -> tuple[float, float]:
    """A column's injected (transfer_s, decode_s): decode at ``DECODE_RATIO``
    times its raw estimate (so ``decode_scale`` settles there), transfer one
    microsecond (``BIG``: 20, most of the priced sum); both scaled by
    ``1 + jitter``."""
    _, raw_d = ex.cost_model.raw_estimate(name)
    t = (20 if name == BIG else 1) * 1e-6
    return t * (1 + jitter), raw_d * DECODE_RATIO * (1 + jitter)


def calibrated(encs) -> StreamingExecutor:
    ex = executor(encs)
    for c in COLUMNS:
        ex.column_profile(c)
        ex.cost_model.observe(c, *timings(ex, c))
    return ex


def observe_all(ex, jitter: float = 0.0) -> None:
    """One run's worth of measurements: every column observed once."""
    for c in COLUMNS:
        ex.cost_model.observe(c, *timings(ex, c, jitter))


def settled(encs) -> StreamingExecutor:
    """A calibrated executor whose first plan has run once and been reused:
    the memo's snapshot is that run's inputs."""
    ex = calibrated(encs)
    ex.plan()
    observe_all(ex)
    ex.plan()
    assert counts(ex) == (1, 1)
    return ex


def fields(ep) -> tuple:
    return (ep.order, {n: dataclasses.asdict(d) for n, d in ep.decisions.items()},
            ep.window, ep.policy, ep.modeled_makespan_s, dict(ep.baselines))


def counts(ex) -> tuple[int, int]:
    return ex.plans_built, ex.plans_reused


def test_the_same_key_reuses_a_copy_of_the_plan(encs):
    ex = calibrated(encs)
    first = ex.plan()
    want = fields(first)
    assert counts(ex) == (1, 0)
    again = ex.plan()
    assert counts(ex) == (1, 1)
    assert fields(again) == want
    assert again.decisions is not first.decisions
    again.decisions.clear()                 # a caller's change reaches no later plan
    first.decisions.pop(BIG)
    third = ex.plan()
    assert counts(ex) == (1, 2) and fields(third) == want


def _recompile(ex, encs):
    ex.compile(BIG, encs[BIG])
    ex.cost_model.observe(BIG, *timings(ex, BIG))


def _forget(ex, encs):
    t, d = timings(ex, BIG)
    ex.cost_model.forget(BIG)
    ex.cost_model.observe(BIG, t, d)        # measured again; its profile is not registered


KEY_CHANGES = {
    "policy": lambda ex, encs: dict(policy="johnson"),
    "chunk_bytes": lambda ex, encs: dict(chunk_bytes=2048),
    "chunk_decode": lambda ex, encs: dict(chunk_decode=False),
    "window": lambda ex, encs: dict(window=3),
    "fused_columns": lambda ex, encs: dict(fused_columns={"L_TAX": None}),
    "names": lambda ex, encs: dict(names=list(COLUMNS[:3])),
    "recompile": lambda ex, encs: _recompile(ex, encs) or {},
    "forget": lambda ex, encs: _forget(ex, encs) or {},
}


@pytest.mark.parametrize("change", tuple(KEY_CHANGES))
def test_each_key_field_changed_alone_searches_again(change, encs):
    ex = calibrated(encs)
    ex.plan()
    scale = ex.cost_model.decode_scale
    kw = KEY_CHANGES[change](ex, encs)
    assert ex.cost_model.decode_scale == pytest.approx(scale)   # no drift: the key alone
    ep = ex.plan(**kw)
    assert counts(ex) == (2, 0)
    assert set(ep.decisions) == set(kw.get("names", COLUMNS))
    ex.plan(**kw)
    assert counts(ex) == (2, 1)              # the new search is the memo's now


def _double_big(ex):
    t, d = timings(ex, BIG)
    ex.cost_model.observe(BIG, 2 * t, d)     # one large column's time doubles


def _scale_moves(ex):
    ex.cost_model.decode_scale *= 1 + 2 * REPLAN_DRIFT


@pytest.mark.parametrize("move", [_double_big, _scale_moves], ids=("big-column-2x", "decode-scale"))
def test_a_drift_past_the_constant_searches_again(move, encs):
    ex = settled(encs)
    move(ex)
    ex.plan()
    assert counts(ex) == (2, 1)


def test_the_first_calibration_searches_again(encs):
    ex = executor(encs)
    ex.plan()                               # raw chip-model estimates
    ex.plan()
    assert counts(ex) == (1, 1)
    observe_all(ex)
    ex.plan()
    assert counts(ex) == (2, 1)


def test_drift_is_measured_from_the_snapshot(encs):
    """Steps each under the constant that add up past it search again."""
    ex = settled(encs)
    step = 0.6 * REPLAN_DRIFT
    for k in (1, 2):
        observe_all(ex, jitter=k * step)
        ex.plan()
    assert counts(ex) == (2, 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timings_jittered_under_the_constant_reuse(seed, encs):
    ex = settled(encs)
    first = ex.plan()
    rng = np.random.default_rng(seed)
    for _ in range(3):
        for c in COLUMNS:
            ex.cost_model.observe(c, *timings(ex, c, jitter=rng.uniform(-0.4, 0.4) * REPLAN_DRIFT))
        assert fields(ex.plan()) == fields(first)
    assert counts(ex) == (1, 5)


def test_a_plan_is_held_to_its_own_first_run_too(encs):
    """A plan at a new chunk size is timed anew: inputs near what its first
    run measured reuse it, here three constants away from what its search
    priced, as do inputs near what it priced; inputs far from both search."""
    ex = settled(encs)
    assert ex.plan(chunk_bytes=2048).decisions[BIG].chunk_bytes == 2048
    assert counts(ex) == (2, 1)
    for jitter in (3, 3, 0, 3):             # its first run, again, as priced, as its first run
        observe_all(ex, jitter=jitter * REPLAN_DRIFT)
        ex.plan(chunk_bytes=2048)
    assert counts(ex) == (2, 5)
    observe_all(ex, jitter=6 * REPLAN_DRIFT)
    ex.plan(chunk_bytes=2048)
    assert counts(ex) == (3, 5)


def test_an_explicit_order_pins_the_order_on_a_hit(encs):
    ex = calibrated(encs)
    first = ex.plan()
    pinned = tuple(reversed(first.order))
    ep = ex.plan(order=pinned)
    assert counts(ex) == (1, 1)
    assert ep.order == pinned and ep.policy == "explicit"
    assert ep.decisions == first.decisions
    assert ex.plan().order == first.order and counts(ex) == (1, 2)


def test_a_run_of_a_reused_plan_is_bitwise_the_source(encs, cols):
    ex = calibrated(encs)
    ex.plan()
    ep = ex.plan()
    assert counts(ex) == (1, 1)
    res = ex.run(plan=ep)
    assert list(res) == list(ep.order)
    for c in COLUMNS:
        a = res[c].array.numpy()
        assert a.dtype == cols[c].dtype
        np.testing.assert_array_equal(a.view(np.uint8), cols[c].view(np.uint8))


def test_the_drift_script_reads_what_a_rehearsed_cell_prices():
    """``scripts/plan_drift.py``, the measurement ``REPLAN_DRIFT`` is set
    from, on the CPU: percentiles of the call-to-call drift, the larger of the
    two distances, and the largest columns' shares of the priced sum."""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "scripts" / "plan_drift.py"), "--workload",
         "tpch-sf8-lineitem-q1q6.load", "--seed", str(2**31 + 9), "--warm", "2",
         "--calls", "5", "--rehearse", "--scale", "0.002"],
        capture_output=True, text=True, check=True, timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["device"] == "cpu" and res["calls"] == 5
    for key in ("times_drift", "scale_drift", "drift"):
        ps = list(res[key].values())
        assert list(res[key]) == ["p50", "p75", "p90", "p95", "p99", "p100"]
        assert all(0 <= a <= b for a, b in zip(ps, ps[1:]))
    assert res["drift"]["p100"] == max(res["times_drift"]["p100"], res["scale_drift"]["p100"])
    shares = [v for _, v in res["column_share"]]
    assert len(shares) == 5 and shares == sorted(shares, reverse=True)
    assert 0 < sum(shares) <= 1 + 1e-9
