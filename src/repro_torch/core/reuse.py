"""Data-reusability accounting — the RAB made functional (paper §4.3.1).

In HiHGNN a redundancy-aware bitmap guards recomputation of projected
features h' and attention coefficients theta.  In a functional framework
the program is *factored* so redundant work is never expressed: h' is
computed once per vertex type, theta once per (vertex, semantic graph),
and everything else gathers.  What remains observable — and what the
paper's Fig. 15 measures — is *memory traffic*: whether the projected
features a semantic graph needs are still resident in the FP buffer left
by the previous graph (reuse) or must be re-fetched from HBM (miss).

``fp_buffer_traffic`` simulates exactly that: an FP-Buf of given capacity
holding per-type projected feature tables, consumed in a given execution
order.  It returns reused vs re-fetched bytes; the serving engine replays
its executed steps through it to report model-vs-measured FP traffic.
``count_reuse`` counts the FP and θ work the factoring saves.

A copy of ``repro.core.reuse``; outputs are identical.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from ..graphs.hetgraph import SemanticGraph


@dataclasses.dataclass
class ReuseCounters:
    """Work counters with and without RAB-style dedup."""

    fp_naive: int = 0      # vertex projections if recomputed per semantic graph
    fp_dedup: int = 0      # vertex projections with type-level dedup (ours)
    theta_naive: int = 0   # coefficient computations if recomputed per edge
    theta_dedup: int = 0   # coefficient computations once per (vertex, graph)

    @property
    def fp_saved(self) -> float:
        return 1.0 - self.fp_dedup / max(self.fp_naive, 1)

    @property
    def theta_saved(self) -> float:
        return 1.0 - self.theta_dedup / max(self.theta_naive, 1)


def count_reuse(sgs: Sequence[SemanticGraph], vertex_counts: Mapping[str, int]) -> ReuseCounters:
    c = ReuseCounters()
    projected_types: set[str] = set()
    for sg in sgs:
        for t in set(sg.path_types) & {sg.src_type, sg.dst_type}:
            c.fp_naive += vertex_counts[t]
            if t not in projected_types:
                c.fp_dedup += vertex_counts[t]
                projected_types.add(t)
        # naive: recompute theta_dst and theta_src per edge endpoint
        c.theta_naive += 2 * sg.num_edges
        c.theta_dedup += sg.num_src + sg.num_dst
    return c


@dataclasses.dataclass(frozen=True)
class FPTraffic:
    reused_bytes: int
    fetched_bytes: int

    @property
    def total(self) -> int:
        return self.reused_bytes + self.fetched_bytes

    @property
    def reuse_fraction(self) -> float:
        return self.reused_bytes / max(self.total, 1)


def fp_buffer_traffic(
    order: Sequence[int],
    sgs: Sequence[SemanticGraph],
    vertex_counts: Mapping[str, int],
    *,
    bytes_per_vertex: Mapping[str, int],
    fpbuf_bytes: int,
) -> FPTraffic:
    """Simulate FP-Buf residency across an execution order of semantic graphs.

    Each semantic graph needs the projected tables of every type on its
    metapath.  Table bytes still resident from the previous graphs are
    reused; the rest are fetched.  Eviction is LRU at table granularity.
    A table larger than the whole buffer can never be fully resident: the
    buffer retains as much of it as fits (a prefix of its blocks) and on
    the next access that resident part is reused while only the missing
    remainder is re-fetched — partial-block refetch, matching the serving
    tier's block-granular FP cache (serve/fp_cache.py) rather than
    charging a full miss.
    """
    resident: dict[str, int] = {}  # type -> resident bytes (<= table size)
    lru: list[str] = []
    reused = 0
    fetched = 0
    for gi in order:
        sg = sgs[gi]
        for t in dict.fromkeys(sg.path_types):  # stable unique
            size = vertex_counts[t] * bytes_per_vertex[t]
            have = min(resident.pop(t, 0), size)
            if t in lru:
                lru.remove(t)
            reused += have
            fetched += size - have
            want = min(size, fpbuf_bytes)  # partial residency if size > buf
            if want == 0:
                continue
            while sum(resident.values()) + want > fpbuf_bytes and lru:
                evict = lru.pop(0)
                del resident[evict]
            resident[t] = want
            lru.append(t)
    return FPTraffic(reused_bytes=reused, fetched_bytes=fetched)
