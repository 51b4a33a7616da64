"""The serve cell's run with its timed path broken comes out not correct, or
counts the broken requests in ``failed``."""
import pytest

from zfbench.faults import run_with_fault


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_a_wrong_column_is_caught(kind):
    res = run_with_fault("tpch-sf4-table2.serve", kind, seed=2**31 + 21, scale=0.005,
                         seconds=1.5)
    assert res["correct"] is False
    assert res["checks"]["mismatched_elements"]["value"] > 0


def test_a_request_never_completed_is_caught():
    res = run_with_fault("tpch-sf4-table2.serve", "lost", seed=2**31 + 22, scale=0.005,
                         seconds=1.5)
    assert res["correct"] is False and res["failed"] == 1
    assert res["checks"]["lost_requests"]["value"] == 1
    assert res["checks"]["mismatched_elements"]["value"] == 0
