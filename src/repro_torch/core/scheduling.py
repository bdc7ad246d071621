"""Similarity-aware execution scheduling of HiHGNN (host-side, numpy).

The paper (§4.3.2) builds a similarity hypergraph over semantic graphs
(edge weight w_e = 1 - eta_e / sum(eta), eta_e = #vertices of shared
types), adds two virtual endpoints with zero-weight edges, makes the
graph complete with weight-1 filler edges, and orders execution by the
shortest Hamilton path (exact Held-Karp DP — #semantic graphs <= ~16 in
practice).  The serving engine applies it to its request queue: a
request exposes ``path_types`` exactly like a semantic graph.

A copy of ``repro.core.scheduling`` (the parts serving and the trainer
use); outputs are identical.  The trainer orders its semantic graphs with
:func:`similarity_schedule`; that order fixes each graph's row in the
stacked attention parameters, so it must match the reference's.
"""
from __future__ import annotations

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


def similarity_schedule(
    sgs: Sequence[SemanticGraph], vertex_counts: Mapping[str, int]
) -> tuple[list[int], np.ndarray]:
    """Execution order of semantic graphs maximizing consecutive FP reuse."""
    w = similarity_matrix(sgs, vertex_counts)
    order, _ = shortest_hamilton_path(w)
    return order, w
