"""The query files: found by name, built into the port's QueryPlan, and
answered by the port's own materialize-then-query engine as the NumPy
reference answers them."""
import numpy as np
import pytest
import torch

from zfbench.data.tpch_gen import generate
from zfbench.lib import queries, registry

NAMES = sorted(p.stem for p in (registry.ZFBENCH / "queries").glob("*.json"))


@pytest.mark.parametrize("name", NAMES)
def test_query_file_builds_a_plan_over_the_reference_s_columns(name):
    qplan = queries.plan(registry.query(name))
    assert qplan.name == name
    assert set(qplan.columns()) <= set(registry.reference_query(name).COLUMNS)


def test_q6_is_the_port_s_q6():
    from repro_torch.data.queries import Q6_PLAN

    assert queries.plan(registry.query("q6")).digest() == Q6_PLAN.digest()


@pytest.mark.parametrize("name", NAMES)
def test_port_engine_answers_as_the_reference(name):
    from repro_torch.data.queries import plan_engine

    cols = generate(0.002, seed=2**31 + 3, columns=registry.reference_query(name).COLUMNS)
    got = plan_engine(queries.plan(registry.query(name)),
                      {n: torch.from_numpy(a) for n, a in cols.items()}).numpy()
    want = registry.reference_query(name).lanes(cols)
    if name == "q6":
        want = want[0, 0]
    else:
        assert np.count_nonzero(want[-1]) == 4      # Q1's four (flag, status) groups
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_an_unknown_operator_is_refused():
    with pytest.raises(ValueError):
        queries.plan({"name": "x", "aggregates": [["a", ["/", 1, ["col", "L_TAX"]]]]})
