"""Scheduling algorithms of HiHGNN (host-side, numpy).

1. Similarity-aware execution scheduling (paper §4.3.2): build a
   similarity hypergraph over semantic graphs (edge weight
   w_e = 1 - eta_e / sum(eta), eta_e = #vertices of shared types), add two
   virtual endpoints with zero-weight edges, make the graph complete with
   weight-1 filler edges, and order execution by the shortest Hamilton
   path (exact Held-Karp DP — #semantic graphs <= ~16 in practice).  The
   serving engine applies it to its request queue: a request exposes
   ``path_types`` exactly like a semantic graph.

2. Workload-aware scheduling (paper §4.2.2): balance edge workloads across
   lanes.  Units of work are dst-block rows (each dst vertex lives in
   exactly one unit, so no cross-lane NA reduction is needed); rows whose
   lane would exceed the allocation threshold spill to the overflow list
   (OW) and are re-assigned to under-loaded lanes, as the paper's Local
   Scheduler does.

A copy of ``repro.core.scheduling``; outputs are identical, array for
array.  The trainer orders its semantic graphs with
:func:`similarity_schedule`; that order fixes each graph's row in the
stacked attention parameters, so it must match the reference's.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Sequence

import numpy as np

from ..graphs.hetgraph import SemanticGraph


def shared_vertex_count(a: SemanticGraph, b: SemanticGraph, vertex_counts: Mapping[str, int]) -> int:
    """eta_e: number of vertices whose projected features both graphs touch
    (vertices of vertex types appearing on both metapaths)."""
    shared = set(a.path_types) & set(b.path_types)
    return int(sum(vertex_counts[t] for t in shared))


def similarity_matrix(sgs: Sequence[SemanticGraph], vertex_counts: Mapping[str, int]) -> np.ndarray:
    """Paper's weights: w_e = 1 - eta_e / sum_i eta_i over real edges; pairs
    with no shared type get weight 1 (the 'completing' gray edges).
    Lower weight == higher similarity == more FP reuse."""
    n = len(sgs)
    eta = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            eta[i, j] = eta[j, i] = shared_vertex_count(sgs[i], sgs[j], vertex_counts)
    total = eta.sum() / 2.0
    w = np.ones((n, n))
    if total > 0:
        nz = eta > 0
        w[nz] = 1.0 - eta[nz] / total
    np.fill_diagonal(w, 0.0)
    return w


def shortest_hamilton_path(w: np.ndarray) -> tuple[list[int], float]:
    """Exact shortest open Hamilton path via Held-Karp DP.

    The paper's two virtual endpoints connected to everything with weight 0
    make the closed-tour formulation equivalent to the min-cost *open* path
    over all (start, end) pairs — which is what this DP computes directly.
    """
    n = w.shape[0]
    if n == 0:
        return [], 0.0
    if n == 1:
        return [0], 0.0
    full = 1 << n
    INF = float("inf")
    dp = np.full((full, n), INF)
    parent = np.full((full, n), -1, np.int32)
    for i in range(n):
        dp[1 << i, i] = 0.0
    for mask in range(full):
        for last in range(n):
            cur = dp[mask, last]
            if cur == INF or not (mask >> last) & 1:
                continue
            rest = ~mask & (full - 1)
            nxt = rest
            while nxt:
                j = (nxt & -nxt).bit_length() - 1
                nxt &= nxt - 1
                nm = mask | (1 << j)
                cand = cur + w[last, j]
                if cand < dp[nm, j]:
                    dp[nm, j] = cand
                    parent[nm, j] = last
    end = int(np.argmin(dp[full - 1]))
    cost = float(dp[full - 1, end])
    order = [end]
    mask = full - 1
    while parent[mask, order[-1]] >= 0:
        p = int(parent[mask, order[-1]])
        mask ^= 1 << order[-1]
        order.append(p)
    order.reverse()
    return order, cost


def brute_force_hamilton_path(w: np.ndarray) -> tuple[list[int], float]:
    """O(n!) oracle for property tests (n <= 7)."""
    n = w.shape[0]
    best, best_cost = list(range(n)), float("inf")
    for perm in itertools.permutations(range(n)):
        c = sum(w[perm[i], perm[i + 1]] for i in range(n - 1))
        if c < best_cost:
            best, best_cost = list(perm), c
    return best, best_cost


def similarity_schedule(
    sgs: Sequence[SemanticGraph], vertex_counts: Mapping[str, int]
) -> tuple[list[int], np.ndarray]:
    """Execution order of semantic graphs maximizing consecutive FP reuse."""
    w = similarity_matrix(sgs, vertex_counts)
    order, _ = shortest_hamilton_path(w)
    return order, w


# ---------------------------------------------------------------------------
# Workload-aware scheduling (lane balancing)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LanePlan:
    """Static lane assignment of work units.

    unit_graph[u], unit_row[u]: which (semantic graph, dst-block row) unit u is.
    unit_lane[u]: the lane executing it.
    lane_load[l]: total edges on lane l.
    """

    unit_graph: np.ndarray
    unit_row: np.ndarray
    unit_cost: np.ndarray
    unit_lane: np.ndarray
    lane_load: np.ndarray

    @property
    def num_lanes(self) -> int:
        return int(self.lane_load.shape[0])

    def imbalance(self) -> float:
        """max/mean lane load — 1.0 is perfect balance."""
        mean = self.lane_load.mean()
        return float(self.lane_load.max() / max(mean, 1e-9))


def _units(row_costs: Sequence[np.ndarray]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(unit_graph int32, unit_row int32, unit_cost float64): one unit per
    (graph, row), graph-major."""
    units_g, units_r, units_c = [], [], []
    for g, rc in enumerate(row_costs):
        for r, c in enumerate(np.asarray(rc)):
            units_g.append(g)
            units_r.append(r)
            units_c.append(float(c))
    return (np.asarray(units_g, np.int32), np.asarray(units_r, np.int32),
            np.asarray(units_c))


def lane_assignment(
    row_costs: Sequence[np.ndarray],
    num_lanes: int,
    *,
    threshold: float | None = None,
) -> LanePlan:
    """Workload-aware scheduling over dst-block-row work units.

    ``row_costs[g][r]`` = #edges of row r of semantic graph g.  Graph g's
    rows start on lane ``g % num_lanes`` (the paper assigns W_i to Lane_i);
    rows that would push the lane past the threshold go to the overflow
    list (OW) and are then greedily placed on the least-loaded lanes
    (largest first).  Threshold defaults to ceil(total/num_lanes).
    """
    unit_graph, unit_row, unit_cost = _units(row_costs)
    total = unit_cost.sum()
    if threshold is None:
        threshold = float(np.ceil(total / max(num_lanes, 1)))

    lane_load = np.zeros(num_lanes)
    unit_lane = np.full(unit_graph.shape[0], -1, np.int32)
    overflow: list[int] = []
    # phase 1: home-lane assignment up to threshold
    for u in range(unit_graph.shape[0]):
        home = int(unit_graph[u]) % num_lanes
        if lane_load[home] + unit_cost[u] <= threshold:
            unit_lane[u] = home
            lane_load[home] += unit_cost[u]
        else:
            overflow.append(u)
    # phase 2: overflow to least-loaded lanes, largest units first (LPT)
    for u in sorted(overflow, key=lambda i: -unit_cost[i]):
        lane = int(np.argmin(lane_load))
        unit_lane[u] = lane
        lane_load[lane] += unit_cost[u]
    return LanePlan(unit_graph, unit_row, unit_cost, unit_lane, lane_load)


def naive_lane_assignment(row_costs: Sequence[np.ndarray], num_lanes: int) -> LanePlan:
    """Baseline without workload-aware scheduling: graph g entirely on lane
    g % num_lanes (the paper's 'w/o' ablation)."""
    unit_graph, unit_row, unit_cost = _units(row_costs)
    unit_lane = (unit_graph % num_lanes).astype(np.int32)
    lane_load = np.zeros(num_lanes)
    np.add.at(lane_load, unit_lane, unit_cost)
    return LanePlan(unit_graph, unit_row, unit_cost, unit_lane, lane_load)
