"""Port parity of workload-aware lane scheduling (paper §4.2.2): the port's
``lane_assignment``, ``naive_lane_assignment`` and ``LanePlan`` against
``repro.core.scheduling``, array for array, over random row costs, lane
counts 1–16 and thresholds; and ``brute_force_hamilton_path`` against the
port's Held-Karp DP, as tests/test_scheduling.py holds the reference's."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import scheduling as jsched
from repro_torch.core import scheduling as tsched

FIELDS = ("unit_graph", "unit_row", "unit_cost", "unit_lane", "lane_load")


def _row_costs(data):
    n_graphs = data.draw(st.integers(1, 5))
    rng = np.random.default_rng(data.draw(st.integers(0, 10_000)))
    return [rng.integers(0, 100, size=rng.integers(1, 20)) for _ in range(n_graphs)]


def _assert_same_plan(t, j):
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert t.num_lanes == j.num_lanes
    assert t.imbalance() == j.imbalance()


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_lane_assignment_equals_the_reference(data):
    row_costs = _row_costs(data)
    lanes = data.draw(st.integers(1, 16))
    threshold = data.draw(st.one_of(st.none(), st.floats(0.0, 500.0)))
    _assert_same_plan(tsched.lane_assignment(row_costs, lanes, threshold=threshold),
                      jsched.lane_assignment(row_costs, lanes, threshold=threshold))


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_naive_lane_assignment_equals_the_reference(data):
    row_costs = _row_costs(data)
    lanes = data.draw(st.integers(1, 16))
    _assert_same_plan(tsched.naive_lane_assignment(row_costs, lanes),
                      jsched.naive_lane_assignment(row_costs, lanes))


def test_balanced_never_loads_a_lane_more_than_naive():
    rng = np.random.default_rng(0)
    row_costs = [rng.integers(0, 100, size=12), rng.integers(0, 10, size=12),
                 rng.integers(50, 400, size=12)]  # skewed graphs, as DBLP's
    for lanes in (2, 4, 8):
        plan = tsched.lane_assignment(row_costs, lanes)
        naive = tsched.naive_lane_assignment(row_costs, lanes)
        assert plan.lane_load.max() <= naive.lane_load.max()
        assert plan.imbalance() <= naive.imbalance()
        assert plan.lane_load.sum() == naive.lane_load.sum() == sum(c.sum() for c in row_costs)


@settings(max_examples=25, deadline=None)
@given(st.integers(2, 6), st.integers(0, 10_000))
def test_held_karp_equals_brute_force(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.random((n, n))
    w = (w + w.T) / 2
    np.fill_diagonal(w, 0)
    order_hk, cost_hk = tsched.shortest_hamilton_path(w)
    order_bf, cost_bf = tsched.brute_force_hamilton_path(w)
    assert sorted(order_hk) == list(range(n))
    assert abs(cost_hk - cost_bf) < 1e-9
    assert (order_bf, cost_bf) == jsched.brute_force_hamilton_path(w)


@pytest.mark.parametrize("n", [0, 1])
def test_hamilton_paths_of_trivial_graphs(n):
    w = np.zeros((n, n))
    assert tsched.brute_force_hamilton_path(w) == jsched.brute_force_hamilton_path(w)
    assert tsched.shortest_hamilton_path(w) == jsched.shortest_hamilton_path(w)
