"""The fused cell's run with its timed path broken comes out not correct."""
import pytest

from zfbench.faults import run_with_fault


def test_sound_run_is_correct():
    res = run_with_fault("tpch-sf8-lineitem-q1q6.fused", None)
    assert res["correct"] is True
    assert res["checks"]["count_lane_mismatches"]["value"] == 0
    assert set(res["metrics"]) == {"cpu_rehearsal.queries_per_s",
                                   "cpu_rehearsal.query_ms.p95", "cpu_rehearsal.setup_s"}


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_fault_is_caught(kind):
    res = run_with_fault("tpch-sf8-lineitem-q1q6.fused", kind)
    assert res["correct"] is False
