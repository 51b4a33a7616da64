"""A load cell's run with its timed path broken comes out not correct."""
import pytest

from zfbench.faults import run_with_fault


def test_sound_run_is_correct():
    res = run_with_fault("tpch-sf8-lineitem-q1q6.load", None)
    assert res["correct"] is True
    assert res["checks"]["mismatched_elements"] == {"value": 0, "limit": 0}
    assert all(k.startswith("cpu_rehearsal.") for k in res["metrics"])
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_fault_is_caught(kind):
    res = run_with_fault("tpch-sf8-lineitem-q1q6.load", kind)
    assert res["correct"] is False
    assert res["checks"]["mismatched_elements"]["value"] > 0
